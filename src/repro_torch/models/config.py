"""Architecture configuration: one frozen dataclass drives model init,
forward and serving for every arch the port runs.

Layer kinds (``pattern``, cycled over the depth):
  "A" global causal attention      "L" local (sliding-window) attention
  "M" Mamba2 SSD                   "R" RG-LRU recurrent block
The port serves all four.  Fields that only the JAX package's training
and sharding read (remat, microbatches, optimizer, sharding modes) are
kept so that a config converts field by field.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..core.layout import Layout

__all__ = ["DTYPES", "ModelConfig", "ShapeCfg"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    """One architecture; ``param_dtype``/``compute_dtype`` are names, the
    torch dtypes are :attr:`param_torch_dtype` / :attr:`compute_torch_dtype`."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # attention
    rope_base: float = 10000.0
    rope_base_local: Optional[float] = None
    rope_mode: str = "half"          # half | interleaved
    rope_fraction: float = 1.0
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None
    pattern: tuple[str, ...] = ("A",)

    # norms / mlp
    norm_kind: str = "rms"           # rms | layernorm
    norm_eps: float = 1e-6
    norm_plus_one: bool = False
    sandwich_norm: bool = False
    mlp_kind: str = "swiglu"         # swiglu | geglu | mlp
    act: str = "silu"

    # embeddings / head
    tie_embeddings: bool = False
    scale_embed: bool = False
    logit_softcap: Optional[float] = None

    # moe
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    d_conv: int = 4

    # rg-lru
    lru_width: int = 0
    rnn_blocks: int = 16

    # enc-dec / modality frontend
    enc_layers: int = 0
    frontend_dim: int = 0
    frontend_tokens: int = 0

    # numerics / perf knobs
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_impl: str = "chunked"       # dense | chunked | tri
    q_chunk: int = 512
    k_chunk: int = 512
    ssd_chunk: int = 128
    kv_layout: Layout = Layout.AOS
    kv_order: str = "bsh"            # cache space order: bsh | bhs
    remat: str = "full"
    microbatches: int = 1
    shard_activations: bool = True
    train_sharding: str = "tp"
    optimizer: str = "adamw"
    zero1: bool = True

    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        """The parameters' torch dtype."""
        return DTYPES[self.param_dtype]

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        """The activations' torch dtype."""
        return DTYPES[self.compute_dtype]

    @property
    def is_encdec(self) -> bool:
        """True for encoder-decoder archs."""
        return self.enc_layers > 0

    # -- TP padding (the port runs one device: tp = 1) --------------------
    def padded_heads(self, tp: int = 1) -> int:
        """Query heads padded so head-TP shards cleanly (pad heads at the
        tail of each KV group); at tp = 1 the published count."""
        if self.n_kv_heads == self.n_heads:
            return -(-self.n_heads // tp) * tp
        G = self.n_heads // self.n_kv_heads
        m = tp // math.gcd(self.n_kv_heads, tp)
        return self.n_kv_heads * (-(-G // m) * m)

    def padded_kv_heads(self, tp: int = 1) -> int:
        """KV heads after padding (MHA pads them with the query heads)."""
        if self.n_kv_heads == self.n_heads:
            return self.padded_heads(tp)
        return self.n_kv_heads

    def padded_vocab(self, tp: int = 1) -> int:
        """Vocabulary padded to a multiple of ``tp``."""
        return -(-self.vocab_size // tp) * tp

    def ssm_heads(self) -> int:
        """Mamba-2 value heads: ``ssm_expand * d_model / ssm_head_dim``."""
        return self.ssm_expand * self.d_model // self.ssm_head_dim

    def padded_ssm_heads(self, tp: int = 1) -> int:
        """SSM heads padded to a multiple of ``tp``."""
        return -(-self.ssm_heads() // tp) * tp

    def layer_groups(self) -> tuple[int, tuple[str, ...], tuple[str, ...]]:
        """(n_groups, group_pattern, tail_pattern): the depth as repeats
        of ``pattern`` plus a partial tail."""
        g = len(self.pattern)
        return (self.n_layers // g, self.pattern,
                self.pattern[: self.n_layers % g])

    def with_(self, **kw) -> "ModelConfig":
        """A copy with fields replaced."""
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeCfg:
    """One input-shape cell."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        """True for a decode cell."""
        return self.kind == "decode"

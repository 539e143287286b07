"""seamless-m4t-medium [audio] — encoder-decoder, multimodal
(arXiv:2308.11596).

12L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206

The backbone only: the speech frontend is a stub supplying precomputed
frame embeddings (dim 1024) under ``"frames"``, which ``frontend_proj``
projects into the 12-layer encoder (full, non-causal self-attention);
each of the 12 text-decoder layers attends to the encoder's output
through a cross-attention whose cache is written once, at prefill, and
read by every decode step.  Positions are RoPE, as in the JAX package
(the published model's are sinusoidal).
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration."""
    return ModelConfig(
        name="seamless_m4t_medium",
        family="encdec",
        n_layers=12,                 # decoder
        enc_layers=12,               # encoder
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,
        norm_kind="layernorm",
        norm_eps=1e-5,
        mlp_kind="mlp",
        act="gelu",
        qkv_bias=True,
        tie_embeddings=True,
        frontend_dim=1024,           # speech-encoder hidden (stub)
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        supports_long_context=False,
    )


def smoke() -> ModelConfig:
    """2 + 2 layers, d_model 64, float32: the CPU tests' size."""
    return config().with_(
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, frontend_dim=32,
        param_dtype="float32", compute_dtype="float32",
        attn_impl="chunked", q_chunk=16, k_chunk=16, remat="none")

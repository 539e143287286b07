"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d (half-dim, interleaved) RoPE  [arXiv:2406.12793].

RoPE rotates only the first half of each head dim with interleaved
pairing (``rope_fraction=0.5, rope_mode="interleaved"``): the first 64
of 128 dims, in even/odd pairs.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration."""
    return ModelConfig(
        name="chatglm3_6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65024,
        rope_base=10_000.0,
        rope_fraction=0.5,
        rope_mode="interleaved",
        qkv_bias=True,
        norm_eps=1e-5,
        mlp_kind="swiglu",
        act="silu",
        tie_embeddings=False,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        supports_long_context=False,
    )


def smoke() -> ModelConfig:
    """2 layers, d_model 64, float32: the CPU tests' size."""
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32",
        attn_impl="chunked", q_chunk=16, k_chunk=16, remat="none")

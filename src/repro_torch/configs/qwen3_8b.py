"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk-norm  [hf:Qwen/Qwen3-8B].

Per-head RMSNorm on q/k before RoPE (``qk_norm=True``).
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration."""
    return ModelConfig(
        name="qwen3_8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        rope_base=1_000_000.0,
        qk_norm=True,
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

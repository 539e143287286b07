"""qwen1.5-4b [dense] — 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936, QKV bias  [hf:Qwen/Qwen1.5-4B].

The port runs one device, so the 20 heads stay 20: the JAX package pads
them to 32 only for its 16-way model axis.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration."""
    return ModelConfig(
        name="qwen1_5_4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab_size=151936,
        rope_base=5_000_000.0,
        qkv_bias=True,
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
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32",
        attn_impl="chunked", q_chunk=16, k_chunk=16, remat="none")

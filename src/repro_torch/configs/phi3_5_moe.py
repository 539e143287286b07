"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2  [hf:microsoft/Phi-3.5-MoE-instruct].

The port runs one device: the 16 experts are one (16, d, 2, f) tensor
on it, routed by ``models/moe.py``.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration."""
    return ModelConfig(
        name="phi3_5_moe",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        n_experts=16,
        top_k=2,
        capacity_factor=1.25,
        norm_eps=1e-5,
        mlp_kind="swiglu",
        act="silu",
        tie_embeddings=False,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        microbatches=2,
        supports_long_context=False,
    )


def smoke() -> ModelConfig:
    """2 layers, d_model 64, 4 experts, float32: the CPU tests' size
    (capacity factor 8: no pair is dropped)."""
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, n_experts=4, microbatches=1,
        capacity_factor=8.0,
        param_dtype="float32", compute_dtype="float32",
        attn_impl="chunked", q_chunk=16, k_chunk=16, remat="none")

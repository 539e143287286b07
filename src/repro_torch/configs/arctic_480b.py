"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + DENSE RESIDUAL
[hf:Snowflake/snowflake-arctic-base].

Arctic's dense-MoE hybrid: every layer runs a dense SwiGLU FFN in
parallel with the 128-expert top-2 routed FFN.  The port runs one
device, so the 56 query heads stay 56 (a GQA group of 7): the JAX
package pads them to 64 only for its 16-way model axis.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration."""
    return ModelConfig(
        name="arctic_480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        n_experts=128,
        top_k=2,
        capacity_factor=1.25,
        dense_residual=True,
        mlp_kind="swiglu",
        act="silu",
        tie_embeddings=False,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        optimizer="adafactor",
        microbatches=4,
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

"""llava-next-mistral-7b [vlm] — Mistral-7B backbone + anyres vision stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

The anyres tiling frontend is a stub: the batch supplies precomputed
patch embeddings (CLIP ViT-L/14 hidden size 1024) under ``"patches"``;
the backbone projects them with ``frontend_proj`` and prepends them to
the text sequence, so a prompt's positions run over the
``FRONTEND_TOKENS`` patch positions and then the text.
"""

from ..models.config import ModelConfig

FRONTEND_TOKENS = 2048  # anyres tiles (stub): image positions per sample


def config() -> ModelConfig:
    """The published configuration."""
    return ModelConfig(
        name="llava_next_mistral_7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        rope_base=1_000_000.0,       # mistral-7b-instruct-v0.2
        mlp_kind="swiglu",
        act="silu",
        tie_embeddings=False,
        frontend_dim=1024,           # CLIP ViT-L/14 hidden
        frontend_tokens=FRONTEND_TOKENS,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        supports_long_context=False,
    )


def smoke() -> ModelConfig:
    """2 layers, d_model 64, 8 patch positions, float32: the CPU tests'
    size."""
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, frontend_dim=32, frontend_tokens=8,
        param_dtype="float32", compute_dtype="float32",
        attn_impl="chunked", q_chunk=16, k_chunk=16, remat="none")

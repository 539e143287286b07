"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global attention  [hf:google/gemma-3-12b-pt].

Pattern (L,L,L,L,L,A) x 8 groups; local ("L") layers attend over a
sliding window of 1024 through a 1024-slot ring cache with RoPE base 10k,
global ("A") layers over the whole sequence with base 1M
(``rope_base_local``).  Gemma conventions: (1+w) RMSNorm, sandwich norms,
embeddings scaled by sqrt(d), tied head, GEGLU, qk-norm.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration."""
    return ModelConfig(
        name="gemma3_12b",
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        pattern=("L", "L", "L", "L", "L", "A"),
        window=1024,
        rope_base=1_000_000.0,
        rope_base_local=10_000.0,
        qk_norm=True,
        norm_plus_one=True,
        sandwich_norm=True,
        scale_embed=True,
        mlp_kind="geglu",
        act="gelu",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        supports_long_context=True,
    )


def smoke() -> ModelConfig:
    """6 layers (one group), d_model 64, window 16, float32: the CPU
    tests' size."""
    return config().with_(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, window=16,
        param_dtype="float32", compute_dtype="float32",
        attn_impl="chunked", q_chunk=16, k_chunk=16, remat="none")

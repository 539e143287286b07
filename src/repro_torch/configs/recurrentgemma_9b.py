"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000, RG-LRU + local attention 2:1  [arXiv:2402.19427].

Pattern (R,R,L): 12 triples + an (R,R) tail = 38 layers.  The attention
layers are local (window 2048, one KV head, a 2048-slot ring cache); the
recurrent layers are RG-LRU (lru_width 4096, block-diagonal gates over 16
blocks) computed with a log-depth scan.  Gemma conventions ((1+w) norm,
sqrt(d) embedding scale, GEGLU, tied head); RoPE on half the head dim.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration."""
    return ModelConfig(
        name="recurrentgemma_9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        pattern=("R", "R", "L"),
        window=2048,
        rope_base=10_000.0,
        rope_fraction=0.5,
        lru_width=4096,
        rnn_blocks=16,
        norm_plus_one=True,
        scale_embed=True,
        mlp_kind="geglu",
        act="gelu",
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        supports_long_context=True,
    )


def smoke() -> ModelConfig:
    """5 layers (one triple and the tail), d_model 64, window 16, float32:
    the CPU tests' size."""
    return config().with_(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, window=16, lru_width=64, rnn_blocks=4,
        param_dtype="float32", compute_dtype="float32",
        attn_impl="chunked", q_chunk=16, k_chunk=16, remat="none")

"""mamba2-130m [ssm] — 24L d_model=768, attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality)  [arXiv:2405.21060].

Pure Mamba2 blocks (no MLP: d_ff=0): d_inner = 2*768 = 1536, head_dim 64
-> 24 SSD value heads, n_groups=1 B/C.
"""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    """The published configuration."""
    return ModelConfig(
        name="mamba2_130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=12,        # unused (attention-free); kept for bookkeeping
        n_kv_heads=12,
        head_dim=64,
        d_ff=0,
        vocab_size=50280,
        pattern=("M",),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        d_conv=4,
        norm_eps=1e-5,
        tie_embeddings=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        supports_long_context=True,
    )


def smoke() -> ModelConfig:
    """2 layers, d_model 64, float32: the CPU tests' size."""
    return config().with_(
        n_layers=2, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssd_chunk=16,
        param_dtype="float32", compute_dtype="float32", remat="none")

"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].
54L d_model=2560 32H (shared attn) d_ff=10240 vocab=32000 ssm_state=64."""
from ..models.common import ArchConfig

ARCH_ID = "zamba2-2.7b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="hybrid", n_layers=54, d_model=2560, n_heads=32,
        n_kv=32, d_ff=10240, vocab=32000, head_dim=80,
        ssm_type="mamba2", d_state=64, expand=2, conv_kernel=4,
        ssm_head_dim=64, attn_every=6, tie_embeddings=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv=4, d_ff=128, vocab=256, head_dim=16,
        ssm_type="mamba2", d_state=16, expand=2, conv_kernel=4,
        ssm_head_dim=16, attn_every=2, remat=False)

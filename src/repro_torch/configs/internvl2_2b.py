"""internvl2-2b [vlm] — InternViT frontend STUB (input_specs provides
precomputed patch embeddings) + InternLM2 backbone [arXiv:2404.16821; hf].
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553."""
from ..models.common import ArchConfig

ARCH_ID = "internvl2-2b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="vlm", n_layers=24, d_model=2048, n_heads=16,
        n_kv=8, d_ff=8192, vocab=92553, head_dim=128, n_patches=256,
        tie_embeddings=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256, head_dim=16, n_patches=8,
        tie_embeddings=False, remat=False)

"""minicpm-2b [dense] — WSD schedule, llama-like arch [arXiv:2404.06395; hf].
40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753."""
from ..models.common import ArchConfig

ARCH_ID = "minicpm-2b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", n_layers=40, d_model=2304, n_heads=36,
        n_kv=36, d_ff=5760, vocab=122753, head_dim=64, tie_embeddings=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=2, d_model=72,
        n_heads=6, n_kv=6, d_ff=144, vocab=256, head_dim=12, remat=False)

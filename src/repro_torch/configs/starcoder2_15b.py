"""starcoder2-15b [dense] — GQA, RoPE [arXiv:2402.19173; hf].
40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152."""
from ..models.common import ArchConfig

ARCH_ID = "starcoder2-15b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", n_layers=40, d_model=6144, n_heads=48,
        n_kv=4, d_ff=24576, vocab=49152, head_dim=128, rope_theta=100_000.0,
        tie_embeddings=False, mlp_gated=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=8, n_kv=2, d_ff=128, vocab=256, head_dim=8,
        tie_embeddings=False, remat=False)

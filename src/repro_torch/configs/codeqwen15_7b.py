"""codeqwen1.5-7b [dense] — qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf].
32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416."""
from ..models.common import ArchConfig

ARCH_ID = "codeqwen1.5-7b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", n_layers=32, d_model=4096, n_heads=32,
        n_kv=32, d_ff=13440, vocab=92416, head_dim=128, rope_theta=1_000_000.0,
        tie_embeddings=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=4, d_ff=128, vocab=256, head_dim=16,
        tie_embeddings=False, remat=False)

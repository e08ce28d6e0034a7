"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].
94L d_model=4096 64H (GQA kv=4) d_ff(expert)=1536 vocab=151936."""
from ..models.common import ArchConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="moe", n_layers=94, d_model=4096, n_heads=64,
        n_kv=4, d_ff=1536, vocab=151936, head_dim=128,
        n_experts=128, top_k=8, n_shared_experts=0, d_expert=1536,
        rope_theta=1_000_000.0, tie_embeddings=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=8, n_kv=2, d_ff=64, vocab=256, head_dim=8,
        n_experts=8, top_k=2, n_shared_experts=0, d_expert=64, remat=False)

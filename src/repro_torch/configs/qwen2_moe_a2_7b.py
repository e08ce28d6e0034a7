"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].
24L d_model=2048 16H (GQA kv=16) d_ff(expert)=1408 vocab=151936."""
from ..models.common import ArchConfig

ARCH_ID = "qwen2-moe-a2.7b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="moe", n_layers=24, d_model=2048, n_heads=16,
        n_kv=16, d_ff=1408, vocab=151936, head_dim=128,
        n_experts=60, top_k=4, n_shared_experts=4, d_expert=1408,
        tie_embeddings=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv=4, d_ff=96, vocab=256, head_dim=16,
        n_experts=8, top_k=2, n_shared_experts=2, d_expert=96, remat=False)

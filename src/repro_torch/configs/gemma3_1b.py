"""gemma3-1b [dense] — 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt; unverified].
26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144."""
from ..models.common import ArchConfig

ARCH_ID = "gemma3-1b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", n_layers=26, d_model=1152, n_heads=4,
        n_kv=1, d_ff=6912, vocab=262144, head_dim=256,
        sliding_window=512, global_every=6,   # layers 6,12,18,24 global
        rope_theta=1_000_000.0, tie_embeddings=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=6, d_model=64,
        n_heads=4, n_kv=1, d_ff=128, vocab=256, head_dim=16,
        sliding_window=8, global_every=3, remat=False)

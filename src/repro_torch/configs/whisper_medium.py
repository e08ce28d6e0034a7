"""whisper-medium [audio] — enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings) [arXiv:2212.04356; unverified].
24L(dec)+24L(enc) d_model=1024 16H d_ff=4096 vocab=51865."""
from ..models.common import ArchConfig

ARCH_ID = "whisper-medium"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="audio", n_layers=24, n_enc_layers=24,
        d_model=1024, n_heads=16, n_kv=16, d_ff=4096, vocab=51865,
        head_dim=64, n_frames=1500, tie_embeddings=True, mlp_gated=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="audio", n_layers=2, n_enc_layers=2,
        d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256, head_dim=16,
        n_frames=16, remat=False, mlp_gated=False)

"""falcon-mamba-7b [ssm] — attention-free mamba1 arch [arXiv:2410.05355;
unverified].  64L d_model=4096 d_ff=0 vocab=65024 ssm_state=16."""
from ..models.common import ArchConfig

ARCH_ID = "falcon-mamba-7b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="ssm", n_layers=64, d_model=4096, n_heads=1,
        n_kv=1, d_ff=0, vocab=65024, ssm_type="mamba1", d_state=16, expand=2,
        conv_kernel=4, dt_rank=256, tie_embeddings=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=1, n_kv=1, d_ff=0, vocab=256, ssm_type="mamba1", d_state=8,
        expand=2, conv_kernel=4, dt_rank=8, remat=False)

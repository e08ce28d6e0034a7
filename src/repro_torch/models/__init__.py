"""Model zoo of the port: config-driven decoder LM backbones (families
``dense`` and ``vlm``) — the counterpart of ``repro.models``."""
from .api import build_model
from .common import ArchConfig, Spec, count_params, init_params
from .convert import params_from_jax

__all__ = ["build_model", "ArchConfig", "Spec", "count_params",
           "init_params", "params_from_jax"]

"""Model zoo of the port: config-driven LM backbones of every family the
reference builds (``dense``, ``moe``, ``vlm``, ``ssm``, ``hybrid``,
``encdec`` / ``audio``) — the counterpart of ``repro.models``."""
from .api import build_model
from .common import ArchConfig, Spec, count_params, init_params
from .convert import params_from_jax

__all__ = ["build_model", "ArchConfig", "Spec", "count_params",
           "init_params", "params_from_jax"]

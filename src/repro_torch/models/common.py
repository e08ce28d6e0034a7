"""Architecture config + spec-driven parameter utilities (the counterpart of
``repro.models.common``).

Parameters are plain nested dicts of torch tensors, in the reference's
tree and layouts (per-layer weights stacked on a leading ``[L, ...]``
axis, projections stored ``[in, out]``).  Every module defines its
parameters once as *specs* (shape + init scale); ``init_params``
materializes them on a device from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..device import resolve_device

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One config covers every assigned family (unused fields ignored).
    Field for field the reference's ``ArchConfig``."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # -- attention pattern ------------------------------------------------
    sliding_window: Optional[int] = None    # local window size (tokens)
    global_every: Optional[int] = None      # gemma3: 1 global per N layers
    mlp_gated: bool = True                  # SwiGLU (True) vs GELU 2-matrix

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0                       # per-expert ffn width
    capacity_factor: float = 1.25

    # -- SSM ---------------------------------------------------------------
    ssm_type: Optional[str] = None          # mamba1 | mamba2
    d_state: int = 16
    expand: int = 2
    conv_kernel: int = 4
    ssm_head_dim: int = 64                  # mamba2 head dim
    dt_rank: Optional[int] = None

    # -- hybrid (zamba2): one *shared* attention block every k ssm layers --
    attn_every: int = 0

    # -- encoder-decoder (whisper) -----------------------------------------
    n_enc_layers: int = 0
    n_frames: int = 1500                    # stub conv-frontend output length

    # -- VLM stub frontend ---------------------------------------------------
    n_patches: int = 0

    # -- compute -----------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    unroll: bool = False            # unroll layer scans (roofline accounting)
    ssm_chunk: int = 0              # 0 = default chunk; -1 = single chunk
    attn_q_chunk: int = 1024        # query-block size for chunked attention
    seq_parallel: bool = False      # shard residual stream seq over 'model'
    moe_local_dispatch: bool = False  # per-dp-block dispatch sort (EP a2a)
    remat_policy: str = "full"      # full | dots | none
    decode_shard: str = "auto"      # auto | seq | heads (KV cache layout)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def n_params(self) -> int:
        """Parameter count from the specs (for MODEL_FLOPS = 6·N·D)."""
        from .api import build_model
        return count_params(build_model(self).param_specs())

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        total = self.n_params()
        if self.family != "moe":
            return total
        per_expert = 3 * self.d_model * self.d_expert
        inactive = (self.n_experts - self.top_k) * per_expert * self.n_layers
        return total - inactive


# ---------------------------------------------------------------------------
# Spec-driven params
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"            # normal | zeros | ones | small
    scale: float = 1.0


def iter_specs(specs: Params, prefix: str = "") -> Iterator[Tuple[str, Spec]]:
    """``(dotted path, Spec)`` for every leaf, in sorted key order."""
    for key in sorted(specs):
        val = specs[key]
        path = f"{prefix}{key}"
        if isinstance(val, Spec):
            yield path, val
        else:
            yield from iter_specs(val, path + ".")


def map_specs(specs: Params, fn, prefix: str = "") -> Params:
    """The spec tree with every leaf replaced by ``fn(path, spec)``, leaves
    visited in sorted key order."""
    out = {}
    for key in sorted(specs):
        val = specs[key]
        path = f"{prefix}{key}"
        out[key] = fn(path, val) if isinstance(val, Spec) else \
            map_specs(val, fn, path + ".")
    return out


def init_params(specs: Params, seed: int = 0, device=None) -> Params:
    """Materialize ``specs`` on ``device`` (default: the first CUDA card)
    from one ``torch.Generator`` seeded with ``seed``, leaves drawn in
    sorted key order.  The reference's scale rule: ``normal`` (and
    ``small``) leaves are fp32 draws times ``scale / sqrt(shape[-2])`` (``shape[-1]`` for 1-D),
    cast to the spec's dtype — so a ``[vocab, d]`` embedding gets
    ``1/sqrt(vocab)``.  The bits differ from ``jax.random``'s; tests hand
    the reference's weights over with ``convert.params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def mk(path, sp: Spec):
        if sp.init == "zeros":
            return torch.zeros(sp.shape, dtype=sp.dtype, device=dev)
        if sp.init == "ones":
            return torch.ones(sp.shape, dtype=sp.dtype, device=dev)
        fan_in = sp.shape[-2] if len(sp.shape) >= 2 else sp.shape[-1]
        std = sp.scale / math.sqrt(max(fan_in, 1))
        w = torch.randn(sp.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_(std).to(sp.dtype)

    return map_specs(specs, mk)


def count_params(specs: Params) -> int:
    return sum(math.prod(sp.shape) for _, sp in iter_specs(specs))

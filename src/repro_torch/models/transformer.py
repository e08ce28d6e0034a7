"""Decoder-only transformer LM (dense, MoE and VLM-backbone variants) —
the counterpart of ``repro.models.transformer``.

Parameters keep the reference's tree, per-layer weights stacked on a
leading ``[L, ...]`` axis; the layer loop is a Python loop over views of
that stack, each layer with its attention window from
:func:`window_pattern` (-1 = global; gemma3's 5 local : 1 global).  MoE
layers use the sort-based dispatch in ``moe.py`` (the block-local one
when ``cfg.moe_local_dispatch``).  Entry points:

  ``logits``      — forward over a whole sequence (scoring)
  ``prefill``     — prompt forward that also fills the KV cache
  ``decode_step`` — single-token step against the cache; its attention
                    core is kernel B5 (``kernels/flash_decode.py``), which
                    takes the layer's window

KV cache layout: ``{"k", "v"}`` each ``[L, b, n_kv, smax, hd]`` in the
compute dtype (the reference's is ``[L, b, smax, n_kv, hd]``), so one
(batch, kv-head) row of a layer is one contiguous ``[smax, hd]`` slab, the
row B5 reads.  ``prefill`` and ``decode_step`` write the cache they are
given in place and return it.  A windowed layer keeps the full-length
cache and B5 reads only the window of it.

``loss`` is the training loss (mean CE, plus ``0.01 x`` the MoE
auxiliary loss); while autograd records it, each layer body is
rematerialised by ``cfg.remat_policy`` (``remat.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.hints import constrain, dp_axes
from .common import ArchConfig, Params, Spec, map_specs
from .layers import (_attend, _project_qkv, attention, attention_decode,
                     attention_specs, embed, embed_specs, mlp, mlp_specs,
                     rms_norm, unembed)
from .losses import cross_entropy
from .moe import moe, moe_local, moe_specs
from .remat import remat


def window_pattern(cfg: ArchConfig) -> np.ndarray:
    """Per-layer attention window (int32, -1 = global): every
    ``global_every``-th layer global, the others ``sliding_window``."""
    if cfg.sliding_window is None:
        return np.full(cfg.n_layers, -1, np.int32)
    w = np.full(cfg.n_layers, cfg.sliding_window, np.int32)
    if cfg.global_every:
        w[cfg.global_every - 1::cfg.global_every] = -1    # every Nth global
    return w


def _layers(params: Params) -> list:
    """Per-layer views of the stacked ``[L, ...]`` parameters, each leaf
    split once by ``torch.unbind``: its gradient is then one stack of the
    layers' gradients (indexing layer ``i`` would give each layer a
    zero-filled gradient of the whole stack, added into the leaf's, L
    times over)."""
    cols = {k: (_layers(v) if isinstance(v, dict) else torch.unbind(v, 0))
            for k, v in params.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens) if not isinstance(
        tokens, torch.Tensor) else tokens, device=device).long()


class DecoderLM:
    """Config-driven decoder-only LM (families ``dense``, ``moe`` and
    ``vlm``)."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.is_moe = cfg.family == "moe"
        self.windows = [int(w) for w in window_pattern(cfg)]

    # -- parameters ---------------------------------------------------------
    def _layer_specs(self) -> Params:
        cfg = self.cfg
        dt = cfg.compute_dtype
        return {
            "ln1": Spec((cfg.d_model,), dt, init="ones"),
            "ln2": Spec((cfg.d_model,), dt, init="ones"),
            "attn": attention_specs(cfg),
            "ffn": moe_specs(cfg) if self.is_moe else mlp_specs(cfg),
        }

    def param_specs(self) -> Params:
        cfg = self.cfg
        stack = map_specs(self._layer_specs(), lambda _, s: Spec(
            (cfg.n_layers,) + s.shape, s.dtype, s.init, s.scale))
        out = {
            "embed": embed_specs(cfg),
            "layers": stack,
            "final_norm": Spec((cfg.d_model,), cfg.compute_dtype,
                               init="ones"),
        }
        if cfg.n_patches:                                 # VLM stub projector
            out["patch_proj"] = Spec((cfg.d_model, cfg.d_model),
                                     cfg.compute_dtype)
        return out

    # -- forward (scoring) ----------------------------------------------------
    def _ffn(self, h, p: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layer's MLP or MoE: ``(y, aux)``."""
        if self.is_moe:
            moe_fn = moe_local if self.cfg.moe_local_dispatch else moe
            return moe_fn(h, p, self.cfg)
        return mlp(h, p), torch.zeros((), dtype=torch.float32,
                                      device=h.device)

    def _block(self, x, p: Params, window: int, positions):
        cfg = self.cfg
        if cfg.seq_parallel:
            # Megatron-SP: the residual stream sharded over sequence on
            # the model axis between blocks (a no-op without a mesh)
            x = constrain(x, dp_axes(), "model", None)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + attention(h, p["attn"], cfg, positions, window)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        y, aux = self._ffn(h, p["ffn"])
        return x + y, aux

    def hidden_states(self, params: Params, x: torch.Tensor,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Final-norm hidden states and the summed MoE auxiliary loss
        (zero for a dense model)."""
        cfg = self.cfg
        body = remat(self._block, cfg.remat_policy if cfg.remat else "none")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, p in enumerate(_layers(params["layers"])):
            x, a = body(x, p, self.windows[i], positions)
            aux = aux + a
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    def inputs_embeds(self, params: Params, tokens,
                      patches: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        dev = params["final_norm"].device
        x = embed(_tokens(tokens, dev), params["embed"])
        if self.cfg.n_patches and patches is not None:
            patches = torch.as_tensor(patches, device=dev).to(x.dtype)
            pe = torch.matmul(patches, params["patch_proj"])
            x = torch.cat([pe, x], dim=1)
        return x

    def logits(self, params: Params, tokens,
               patches: Optional[torch.Tensor] = None):
        """``(logits [b, s, vocab], aux)`` over the whole sequence."""
        x = self.inputs_embeds(params, tokens, patches)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        h, aux = self.hidden_states(params, x, positions)
        return unembed(h, params["embed"]), aux

    def loss(self, params: Params, batch) -> torch.Tensor:
        """batch: tokens [b, s], labels [b, s] (-1 = ignore), optional
        patches [b, p, d] (their positions carry label -1)."""
        logits, aux = self.logits(params, batch["tokens"],
                                  batch.get("patches"))
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        if self.cfg.n_patches and "patches" in batch:
            pad = torch.full(batch["patches"].shape[:2], -1,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        return cross_entropy(logits, labels) + 0.01 * aux

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None) -> Params:
        """Zeroed KV cache ``[L, batch, n_kv, max_len, hd]`` on ``device``
        (default: the first CUDA card)."""
        cfg = self.cfg
        dev = resolve_device(device)
        shape = (cfg.n_layers, batch, cfg.n_kv, max_len, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}

    def prefill(self, params: Params, tokens, cache: Params,
                patches: Optional[torch.Tensor] = None):
        """Prompt forward; returns ``(last-token logits [b, 1, vocab],
        cache)`` with positions ``[0, s)`` of ``cache`` written in place
        (``cache`` may be a view of some slots of a larger cache)."""
        cfg = self.cfg
        x = self.inputs_embeds(params, tokens, patches)
        s = x.shape[1]
        if s > cache["k"].shape[3]:
            raise ValueError(f"a prompt of {s} positions does not fit a "
                             f"cache of {cache['k'].shape[3]}")
        positions = torch.arange(s, device=x.device)[None, :]
        for i, p in enumerate(_layers(params["layers"])):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = _project_qkv(h, p["attn"], cfg, positions)
            x = x + _attend(q, k, v, positions, positions, p["attn"]["wo"],
                            cfg, self.windows[i])
            cache["k"][i, :, :, :s] = k.transpose(1, 2)
            cache["v"][i, :, :, :s] = v.transpose(1, 2)
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + self._ffn(h2, p["ffn"])[0]
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(h[:, -1:], params["embed"]), cache

    def decode_step(self, params: Params, token, cache: Params, pos):
        """token [b, 1], pos [b] current positions (each ``< smax``).
        Returns ``(logits [b, 1, vocab], cache)``, the token's K/V written
        into ``cache`` in place; each layer's attention is one B5 launch
        with the layer's window."""
        cfg = self.cfg
        dev = params["final_norm"].device
        pos = torch.as_tensor(pos, device=dev).long()
        lengths = pos.to(torch.int32).repeat_interleave(cfg.n_kv)
        x = embed(_tokens(token, dev), params["embed"])
        for i, p in enumerate(_layers(params["layers"])):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + attention_decode(h, p["attn"], cfg, cache["k"][i],
                                     cache["v"][i], pos, lengths,
                                     self.windows[i])
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + self._ffn(h2, p["ffn"])[0]
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(h, params["embed"]), cache

"""Attention-free SSM LM (falcon-mamba): a stack of Mamba-1 blocks — the
counterpart of ``repro.models.ssm_lm``.

State cache (O(1) in sequence length), slot axis at dim 1 like every
cache of the port: ``conv [L, b, k-1, d_inner]`` in the compute dtype and
``ssm [L, b, d_inner, d_state]`` in fp32.  ``prefill`` fills both from
the prompt's chunked scan (the reference returns the cache untouched and
decodes after a prompt from a zero state; see ROADMAP's deliberate
divergences), overwriting whatever the slot held; ``decode_step`` writes
them in place.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .common import ArchConfig, Params, Spec, map_specs
from .layers import embed, embed_specs, rms_norm, unembed
from .losses import cross_entropy
from .remat import remat
from .ssm import mamba1_decode, mamba1_scan, mamba1_specs
from .transformer import _layers, _tokens


class SSMLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.ssm_type != "mamba1":
            raise ValueError(f"SSMLM runs mamba1 layers, got "
                             f"{cfg.ssm_type!r}")
        self.cfg = cfg

    def _layer_specs(self) -> Params:
        return {"ln": Spec((self.cfg.d_model,), self.cfg.compute_dtype,
                           init="ones"),
                "ssm": mamba1_specs(self.cfg)}

    def param_specs(self) -> Params:
        cfg = self.cfg
        stack = map_specs(self._layer_specs(), lambda _, s: Spec(
            (cfg.n_layers,) + s.shape, s.dtype, s.init, s.scale))
        return {"embed": embed_specs(cfg), "layers": stack,
                "final_norm": Spec((cfg.d_model,), cfg.compute_dtype,
                                   init="ones")}

    def _chunk(self, seq_len: int) -> int:
        if self.cfg.ssm_chunk == -1:
            return seq_len
        return self.cfg.ssm_chunk or 64

    def _block(self, x, p: Params, chunk: int):
        """One layer: ``(x + mamba1(norm(x)), conv_state, ssm_state)``."""
        h = rms_norm(x, p["ln"], self.cfg.norm_eps)
        y, conv, ssm = mamba1_scan(h, p["ssm"], self.cfg, chunk)
        return x + y, conv, ssm

    def _forward(self, params: Params, tokens, cache=None):
        """Final-norm hidden states; with ``cache``, each layer's final
        states are written into it.  Under autograd each layer is
        rematerialised when ``cfg.remat`` is set (the reference ignores
        ``remat_policy`` here)."""
        cfg = self.cfg
        x = embed(_tokens(tokens, params["final_norm"].device),
                  params["embed"])
        chunk = self._chunk(x.shape[1])
        body = remat(self._block, "full" if cfg.remat else "none")
        for i, p in enumerate(_layers(params["layers"])):
            x, conv, ssm = body(x, p, chunk)
            if cache is not None:
                cache["conv"][i].copy_(conv)
                cache["ssm"][i].copy_(ssm)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def logits(self, params: Params, tokens, patches=None):
        h = self._forward(params, tokens)
        return unembed(h, params["embed"]), torch.zeros(
            (), dtype=torch.float32, device=h.device)

    def loss(self, params: Params, batch) -> torch.Tensor:
        logits, _ = self.logits(params, batch["tokens"])
        return cross_entropy(logits, batch["labels"])

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None) -> Params:
        """Zeroed states on ``device`` (default: the first CUDA card);
        ``max_len`` is unused (the state does not grow)."""
        cfg = self.cfg
        dev = resolve_device(device)
        return {
            "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                                 cfg.d_inner), dtype=cfg.compute_dtype,
                                device=dev),
            "ssm": torch.zeros((cfg.n_layers, batch, cfg.d_inner,
                                cfg.d_state), dtype=torch.float32,
                               device=dev),
        }

    def prefill(self, params: Params, tokens, cache: Params, patches=None):
        """Prompt forward; returns ``(last-token logits [b, 1, vocab],
        cache)`` with each layer's final conv and SSM states written into
        ``cache`` in place (``cache`` may be a view of some slots)."""
        h = self._forward(params, tokens, cache)
        return unembed(h[:, -1:], params["embed"]), cache

    def decode_step(self, params: Params, token, cache: Params, pos):
        """token [b, 1]; ``pos`` is unused (the state carries the
        position).  Returns ``(logits [b, 1, vocab], cache)``, the states
        advanced in place."""
        cfg = self.cfg
        x = embed(_tokens(token, params["final_norm"].device),
                  params["embed"])
        for i, p in enumerate(_layers(params["layers"])):
            h = rms_norm(x, p["ln"], cfg.norm_eps)
            y, conv, ssm = mamba1_decode(h, p["ssm"], cfg, cache["conv"][i],
                                         cache["ssm"][i])
            x = x + y
            cache["conv"][i].copy_(conv)
            cache["ssm"][i].copy_(ssm)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(h, params["embed"]), cache

"""Zamba2-style hybrid: a Mamba-2 backbone and one *shared* attention
block (the same weights every time) after every ``attn_every`` SSM
layers — the counterpart of ``repro.models.hybrid``.

54 mamba layers / attn_every = 6 => 9 groups; group g is 6 mamba2 layers
followed by the shared (attention + MLP) block.  The parameter tree keeps
the reference's ``ssm_layers`` stack ``[n_groups, attn_every, ...]``.

Cache, slot axis at dim 1 in every entry (so the batcher's slot view
``c[:, slot:slot + 1]`` is right for it): ``conv [L, b, k-1, di + 2 ds]``
and ``ssm [L, b, H, hd, ds]`` (fp32) with layer ``g * attn_every + j``,
and the shared block's K/V per invocation ``k`` / ``v [n_groups, b,
n_kv, smax, hd]``.  (The reference's ``[g, attn_every, b, ...]`` puts the
slot axis at dim 2.)  ``prefill`` fills all of them from the prompt.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .common import ArchConfig, Params, Spec, map_specs
from .layers import (_attend, _project_qkv, attention_decode,
                     attention_specs, embed, embed_specs, mlp, mlp_specs,
                     rms_norm, unembed)
from .losses import cross_entropy
from .remat import remat
from .ssm import mamba2_decode, mamba2_scan, mamba2_specs
from .transformer import _layers, _tokens


class HybridLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.ssm_type != "mamba2" or cfg.attn_every <= 0 \
                or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: HybridLM needs mamba2 layers in "
                             f"whole groups of attn_every > 0")
        self.cfg = cfg
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.window = cfg.sliding_window if cfg.sliding_window else -1

    def _ssm_layer_specs(self) -> Params:
        return {"ln": Spec((self.cfg.d_model,), self.cfg.compute_dtype,
                           init="ones"),
                "ssm": mamba2_specs(self.cfg)}

    def param_specs(self) -> Params:
        cfg = self.cfg
        stack = map_specs(self._ssm_layer_specs(), lambda _, s: Spec(
            (self.n_groups, cfg.attn_every) + s.shape, s.dtype, s.init,
            s.scale))
        dt = cfg.compute_dtype
        shared = {
            "ln1": Spec((cfg.d_model,), dt, init="ones"),
            "attn": attention_specs(cfg),
            "ln2": Spec((cfg.d_model,), dt, init="ones"),
            "mlp": mlp_specs(cfg),
        }
        return {"embed": embed_specs(cfg), "ssm_layers": stack,
                "shared": shared,
                "final_norm": Spec((cfg.d_model,), dt, init="ones")}

    def _chunk(self, seq_len: int) -> int:
        if self.cfg.ssm_chunk == -1:
            return seq_len
        return self.cfg.ssm_chunk or 128

    # -- forward ----------------------------------------------------------------
    def _ssm_block(self, x, p: Params, chunk: int):
        """One Mamba-2 layer: ``(x + mamba2(norm(x)), conv, ssm)``."""
        h = rms_norm(x, p["ln"], self.cfg.norm_eps)
        y, conv, ssm = mamba2_scan(h, p["ssm"], self.cfg, chunk)
        return x + y, conv, ssm

    def _forward(self, params: Params, tokens, cache=None):
        """Final-norm hidden states; with ``cache``, every layer's final
        states and the shared block's K/V are written into it.  Under
        autograd each Mamba-2 layer (not the shared block) is
        rematerialised when ``cfg.remat`` is set, as in the reference."""
        cfg = self.cfg
        x = embed(_tokens(tokens, params["final_norm"].device),
                  params["embed"])
        s = x.shape[1]
        if cache is not None and s > cache["k"].shape[3]:
            raise ValueError(f"a prompt of {s} positions does not fit a "
                             f"cache of {cache['k'].shape[3]}")
        positions = torch.arange(s, device=x.device)[None, :]
        chunk = self._chunk(s)
        sp = params["shared"]
        body = remat(self._ssm_block, "full" if cfg.remat else "none")
        for g, pg in enumerate(_layers(params["ssm_layers"])):
            for j, p in enumerate(_layers(pg)):
                x, conv, ssm = body(x, p, chunk)
                if cache is not None:
                    cache["conv"][g * cfg.attn_every + j].copy_(conv)
                    cache["ssm"][g * cfg.attn_every + j].copy_(ssm)
            h = rms_norm(x, sp["ln1"], cfg.norm_eps)
            q, k, v = _project_qkv(h, sp["attn"], cfg, positions)
            x = x + _attend(q, k, v, positions, positions, sp["attn"]["wo"],
                            cfg, self.window)
            if cache is not None:
                cache["k"][g, :, :, :s] = k.transpose(1, 2)
                cache["v"][g, :, :, :s] = v.transpose(1, 2)
            h = rms_norm(x, sp["ln2"], cfg.norm_eps)
            x = x + mlp(h, sp["mlp"])
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def logits(self, params: Params, tokens, patches=None):
        h = self._forward(params, tokens)
        return unembed(h, params["embed"]), torch.zeros(
            (), dtype=torch.float32, device=h.device)

    def loss(self, params: Params, batch) -> torch.Tensor:
        logits, _ = self.logits(params, batch["tokens"])
        return cross_entropy(logits, batch["labels"])

    # -- serving ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None) -> Params:
        cfg = self.cfg
        dev = resolve_device(device)
        nh = cfg.d_inner // cfg.ssm_head_dim
        kv = (self.n_groups, batch, cfg.n_kv, max_len, cfg.hd)
        return {
            "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                                 cfg.d_inner + 2 * cfg.d_state),
                                dtype=cfg.compute_dtype, device=dev),
            "ssm": torch.zeros((cfg.n_layers, batch, nh, cfg.ssm_head_dim,
                                cfg.d_state), dtype=torch.float32,
                               device=dev),
            "k": torch.zeros(kv, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(kv, dtype=cfg.compute_dtype, device=dev),
        }

    def prefill(self, params: Params, tokens, cache: Params, patches=None):
        """Prompt forward; returns ``(last-token logits [b, 1, vocab],
        cache)``, the states and positions ``[0, s)`` of the K/V written
        into ``cache`` in place."""
        h = self._forward(params, tokens, cache)
        return unembed(h[:, -1:], params["embed"]), cache

    def decode_step(self, params: Params, token, cache: Params, pos):
        """token [b, 1], pos [b] (each ``< smax``).  Returns ``(logits
        [b, 1, vocab], cache)``; each group's shared attention is one B5
        launch."""
        cfg = self.cfg
        dev = params["final_norm"].device
        pos = torch.as_tensor(pos, device=dev).long()
        lengths = pos.to(torch.int32).repeat_interleave(cfg.n_kv)
        x = embed(_tokens(token, dev), params["embed"])
        sp = params["shared"]
        for g, pg in enumerate(_layers(params["ssm_layers"])):
            for j, p in enumerate(_layers(pg)):
                li = g * cfg.attn_every + j
                h = rms_norm(x, p["ln"], cfg.norm_eps)
                y, conv, ssm = mamba2_decode(h, p["ssm"], cfg,
                                             cache["conv"][li],
                                             cache["ssm"][li])
                x = x + y
                cache["conv"][li].copy_(conv)
                cache["ssm"][li].copy_(ssm)
            h = rms_norm(x, sp["ln1"], cfg.norm_eps)
            x = x + attention_decode(h, sp["attn"], cfg, cache["k"][g],
                                     cache["v"][g], pos, lengths,
                                     self.window)
            h = rms_norm(x, sp["ln2"], cfg.norm_eps)
            x = x + mlp(h, sp["mlp"])
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(h, params["embed"]), cache

"""Encoder-decoder transformer backbone (whisper-medium) — the
counterpart of ``repro.models.encdec``.

The conv / audio frontend is a stub, as in the reference: the model
consumes precomputed frame embeddings ``[b, n_frames, d_model]``.
Encoder = bidirectional attention stack; decoder = causal self-attention
plus cross-attention to the encoder output.

Cache, slot axis at dim 1: self-attention ``k`` / ``v [L, b, n_kv, smax,
hd]`` and cross-attention ``xk`` / ``xv [L, b, n_kv, n_frames, hd]``, in
the compute dtype.  ``prefill`` encodes the frames, fills the cross K/V
and the prompt's self-attention K/V (the reference fills only the cross
K/V).  Each decoder layer of a decode step makes two B5 launches: its
self-attention over ``[0, pos]`` and its cross-attention over all
``n_frames`` rows (lengths ``n_frames - 1``, global: the reference's
``_attend(..., GLOBAL, causal=False)``).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels import flash_decode as _fd
from .common import ArchConfig, Params, Spec, map_specs
from .layers import (_attend, _project_qkv, attention, attention_decode,
                     attention_specs, embed, embed_specs, mlp, mlp_specs,
                     rms_norm, unembed)
from .losses import cross_entropy
from .remat import remat
from .transformer import _layers, _tokens


def _stack(n: int, specs: Params) -> Params:
    return map_specs(specs, lambda _, s: Spec((n,) + s.shape, s.dtype,
                                              s.init, s.scale))


class EncDecLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.n_enc_layers <= 0:
            raise ValueError(f"{cfg.name}: EncDecLM needs n_enc_layers > 0")
        self.cfg = cfg

    def _enc_layer_specs(self) -> Params:
        cfg = self.cfg
        dt = cfg.compute_dtype
        return {"ln1": Spec((cfg.d_model,), dt, init="ones"),
                "attn": attention_specs(cfg),
                "ln2": Spec((cfg.d_model,), dt, init="ones"),
                "mlp": mlp_specs(cfg)}

    def _dec_layer_specs(self) -> Params:
        cfg = self.cfg
        dt = cfg.compute_dtype
        return {"ln1": Spec((cfg.d_model,), dt, init="ones"),
                "self_attn": attention_specs(cfg),
                "ln_x": Spec((cfg.d_model,), dt, init="ones"),
                "cross_attn": attention_specs(cfg),
                "ln2": Spec((cfg.d_model,), dt, init="ones"),
                "mlp": mlp_specs(cfg)}

    def param_specs(self) -> Params:
        cfg = self.cfg
        dt = cfg.compute_dtype
        return {
            "embed": embed_specs(cfg),
            "enc_layers": _stack(cfg.n_enc_layers, self._enc_layer_specs()),
            "dec_layers": _stack(cfg.n_layers, self._dec_layer_specs()),
            "enc_norm": Spec((cfg.d_model,), dt, init="ones"),
            "final_norm": Spec((cfg.d_model,), dt, init="ones"),
        }

    # -- encoder -------------------------------------------------------------
    def encode(self, params: Params, frames) -> torch.Tensor:
        """frames [b, nf, d] (stub frontend output) -> [b, nf, d]."""
        cfg = self.cfg
        if frames is None:
            raise ValueError(f"{cfg.name} needs frames [b, n_frames, "
                             f"d_model] (prefill's fourth argument)")
        dev = params["final_norm"].device
        x = torch.as_tensor(frames, device=dev).to(cfg.compute_dtype)
        positions = torch.arange(x.shape[1], device=dev)[None, :]
        body = remat(self._enc_block, "full" if cfg.remat else "none")
        for p in _layers(params["enc_layers"]):
            x = body(x, p, positions)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _enc_block(self, x, p: Params, positions):
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + attention(h, p["attn"], cfg, positions, causal=False)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + mlp(h, p["mlp"])

    def _cross_kv(self, enc_out, p: Params):
        """The cross K/V of one decoder layer: [b, nf, n_kv, hd] each."""
        cfg = self.cfg
        b, nf = enc_out.shape[:2]
        return (torch.matmul(enc_out, p["wk"]).reshape(b, nf, cfg.n_kv,
                                                       cfg.hd),
                torch.matmul(enc_out, p["wv"]).reshape(b, nf, cfg.n_kv,
                                                       cfg.hd))

    # -- decoder forward -------------------------------------------------------
    def _dec_block(self, x, p: Params, enc_out, positions, enc_pos):
        """One decoder layer: ``(x, k, v, xk, xv)``, its self- and
        cross-attention K/V beside the output."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(h, p["self_attn"], cfg, positions)
        x = x + _attend(q, k, v, positions, positions, p["self_attn"]["wo"],
                        cfg)
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        xk, xv = self._cross_kv(enc_out, p["cross_attn"])
        x = x + attention(h, p["cross_attn"], cfg, positions, causal=False,
                          kv=(xk, xv), kv_positions=enc_pos)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + mlp(h, p["mlp"]), k, v, xk, xv

    def _decode_all(self, params: Params, tokens, enc_out, cache=None):
        """Decoder over the whole ``tokens``: final-norm hidden states;
        with ``cache``, the self- and cross-attention K/V are written
        into it.  Under autograd each encoder and decoder layer is
        rematerialised when ``cfg.remat`` is set, as in the reference."""
        cfg = self.cfg
        dev = params["final_norm"].device
        x = embed(_tokens(tokens, dev), params["embed"])
        s = x.shape[1]
        if cache is not None and s > cache["k"].shape[3]:
            raise ValueError(f"a prompt of {s} positions does not fit a "
                             f"cache of {cache['k'].shape[3]}")
        positions = torch.arange(s, device=dev)[None, :]
        enc_pos = torch.arange(enc_out.shape[1], device=dev)[None, :]
        body = remat(self._dec_block, "full" if cfg.remat else "none")
        for i, p in enumerate(_layers(params["dec_layers"])):
            x, k, v, xk, xv = body(x, p, enc_out, positions, enc_pos)
            if cache is not None:
                cache["k"][i, :, :, :s] = k.transpose(1, 2)
                cache["v"][i, :, :, :s] = v.transpose(1, 2)
                cache["xk"][i].copy_(xk.transpose(1, 2))
                cache["xv"][i].copy_(xv.transpose(1, 2))
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def logits(self, params: Params, tokens, frames=None):
        h = self._decode_all(params, tokens, self.encode(params, frames))
        return unembed(h, params["embed"]), torch.zeros(
            (), dtype=torch.float32, device=h.device)

    def loss(self, params: Params, batch) -> torch.Tensor:
        """batch: tokens, labels [b, s] and frames [b, n_frames, d]."""
        logits, _ = self.logits(params, batch["tokens"], batch["frames"])
        return cross_entropy(logits, batch["labels"])

    # -- serving ----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None) -> Params:
        cfg = self.cfg
        dev = resolve_device(device)
        self_kv = (cfg.n_layers, batch, cfg.n_kv, max_len, cfg.hd)
        cross = (cfg.n_layers, batch, cfg.n_kv, cfg.n_frames, cfg.hd)
        return {name: torch.zeros(shape, dtype=cfg.compute_dtype,
                                  device=dev)
                for name, shape in (("k", self_kv), ("v", self_kv),
                                    ("xk", cross), ("xv", cross))}

    def prefill(self, params: Params, tokens, cache: Params, frames=None):
        """Encode ``frames``, fill the cross K/V and the prompt's
        self-attention K/V in place; returns ``(last-token logits
        [b, 1, vocab], cache)``."""
        enc_out = self.encode(params, frames)
        if enc_out.shape[1] != cache["xk"].shape[3]:
            raise ValueError(f"{enc_out.shape[1]} frames, the cache holds "
                             f"{cache['xk'].shape[3]}")
        h = self._decode_all(params, tokens, enc_out, cache)
        return unembed(h[:, -1:], params["embed"]), cache

    def decode_step(self, params: Params, token, cache: Params, pos):
        """token [b, 1], pos [b] (each ``< smax``).  Returns ``(logits
        [b, 1, vocab], cache)``, the token's K/V written in place."""
        cfg = self.cfg
        dev = params["final_norm"].device
        pos = torch.as_tensor(pos, device=dev).long()
        b = pos.shape[0]
        lengths = pos.to(torch.int32).repeat_interleave(cfg.n_kv)
        nf = cache["xk"].shape[3]
        cross_len = torch.full((b * cfg.n_kv,), nf - 1, dtype=torch.int32,
                               device=dev)
        g = cfg.n_heads // cfg.n_kv
        x = embed(_tokens(token, dev), params["embed"])
        for i, p in enumerate(_layers(params["dec_layers"])):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + attention_decode(h, p["self_attn"], cfg, cache["k"][i],
                                     cache["v"][i], pos, lengths)
            h = rms_norm(x, p["ln_x"], cfg.norm_eps)
            q = torch.matmul(h, p["cross_attn"]["wq"])
            o = _fd.flash_decode_call(
                q.reshape(b * cfg.n_kv, g, cfg.hd),
                cache["xk"][i].reshape(b * cfg.n_kv, nf, cfg.hd),
                cache["xv"][i].reshape(b * cfg.n_kv, nf, cfg.hd), cross_len)
            x = x + torch.matmul(o.reshape(b, 1, cfg.n_heads * cfg.hd),
                                 p["cross_attn"]["wo"])
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp(h, p["mlp"])
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(h, params["embed"]), cache

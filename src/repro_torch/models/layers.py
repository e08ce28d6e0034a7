"""Transformer building blocks: RMSNorm, RoPE, GQA attention (full /
causal / sliding-window prefill and forward, cross-attention, and the
KV-cache decode step through kernel B5), SwiGLU / GELU MLP — the
counterpart of ``repro.models.layers``.

The arithmetic and its rounding points follow the reference: RMSNorm
reduces in fp32 and casts before the weight, RoPE is the half-split
variant with ``theta^(-i/half)`` frequencies, prefill scores are a
working-dtype product divided in fp32, the softmax runs in fp32 and its
probabilities are cast back before the value product.  The attention
window is a per-layer Python int (-1 = global), the reference's dynamic
scalar.  The decode attention core is
:func:`repro_torch.kernels.flash_decode.flash_decode_call` and nothing
else.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import flash_decode as _fd
from .common import ArchConfig, Spec

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x [b, s, h, hd], positions [b, s] (or [s])."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs               # [b, s, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
def attention_specs(cfg: ArchConfig, d_model: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    hd = cfg.hd
    dt = cfg.compute_dtype
    return {
        "wq": Spec((d, cfg.n_heads * hd), dt),
        "wk": Spec((d, cfg.n_kv * hd), dt),
        "wv": Spec((d, cfg.n_kv * hd), dt),
        "wo": Spec((cfg.n_heads * hd, d), dt),
    }


def _project_qkv(x, p: Params, cfg: ArchConfig, positions):
    """Projections + RoPE: q [b, s, h, hd], k / v [b, s, n_kv, hd]."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = torch.matmul(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = torch.matmul(x, p["wk"]).reshape(b, s, cfg.n_kv, hd)
    v = torch.matmul(x, p["wv"]).reshape(b, s, cfg.n_kv, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attention(x: torch.Tensor, p: Params, cfg: ArchConfig,
              positions: torch.Tensor, window: int = -1,
              causal: bool = True,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over ``x [b, s, d]`` at absolute ``positions
    [b, s]`` (RoPE on q and k), or cross-attention to ``kv = (k, v)``
    ``[b, sk, n_kv, hd]`` at ``kv_positions`` (no RoPE, as the
    reference)."""
    if kv is None:
        q, k, v = _project_qkv(x, p, cfg, positions)
        k_pos = positions
    else:
        b, s, _ = x.shape
        q = torch.matmul(x, p["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
        (k, v), k_pos = kv, kv_positions
    return _attend(q, k, v, positions, k_pos, p["wo"], cfg, window, causal)


def _window_mask(q_pos, k_pos, window: int, causal: bool) -> torch.Tensor:
    """``[.., sq] x [.., sk]`` positions -> the boolean mask ``[.., sq,
    sk]`` of the keys each query sees: ``q >= k`` when ``causal``, and
    ``q - k <= window`` for a window >= 0."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window >= 0:
        ok &= diff <= window
    return ok


def _attend_block(q, k, v, q_pos, k_pos, window: int, causal: bool):
    """Unchunked grouped-GQA core: q [b,sq,kv,g,hd] x k/v [b,sk,kv,hd]
    -> [b,sq,kv,g,hd], without a head-repeated KV copy."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() \
        / math.sqrt(hd)
    ok = _window_mask(q_pos, k_pos, window, causal)
    scores = scores.masked_fill(~ok[:, None, None], -1e30)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", attn, v)


def _attend(q, k, v, q_pos, k_pos, wo, cfg: ArchConfig, window: int = -1,
            causal: bool = True):
    """Attention with the reference's query-block chunking: the
    ``[b, h, sq, sk]`` scores exist one ``cfg.attn_q_chunk`` block at a
    time when ``sq`` is a multiple of it, else in one block."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    if q_pos.dim() == 1:
        q_pos = q_pos[None, :]
    if k_pos.dim() == 1:
        k_pos = k_pos[None, :]
    q_pos = q_pos.expand(b, sq)
    chunk = cfg.attn_q_chunk
    if sq <= chunk or sq % chunk != 0:
        o = _attend_block(qg, k, v, q_pos, k_pos, window, causal)
    else:
        o = torch.cat([_attend_block(qg[:, c0:c0 + chunk], k, v,
                                     q_pos[:, c0:c0 + chunk], k_pos, window,
                                     causal)
                       for c0 in range(0, sq, chunk)], dim=1)
    return torch.matmul(o.reshape(b, sq, h * hd), wo)


def attention_decode(x: torch.Tensor, p: Params, cfg: ArchConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor, lengths: torch.Tensor,
                     window: int = -1) -> torch.Tensor:
    """One decode step of one layer: append K/V at ``pos`` and attend over
    the filled prefix ``[0, pos]`` (the last ``window + 1`` positions of
    it for a window >= 0) through kernel B5.

    x [b, 1, d]; cache_k / cache_v [b, n_kv, smax, hd] (this layer's slab,
    written in place); pos [b] int64; lengths [b * n_kv] int32 (``pos``
    per kv-head row).  Returns out [b, 1, d]."""
    b = x.shape[0]
    hd = cfg.hd
    q, k, v = _project_qkv(x, p, cfg, pos[:, None])
    _scatter_t(cache_k, k, pos)
    _scatter_t(cache_v, v, pos)
    n_kv, smax = cache_k.shape[1], cache_k.shape[2]
    g = cfg.n_heads // n_kv
    o = _fd.flash_decode_call(q.reshape(b * n_kv, g, hd),
                              cache_k.reshape(b * n_kv, smax, hd),
                              cache_v.reshape(b * n_kv, smax, hd), lengths,
                              window)
    return torch.matmul(o.reshape(b, 1, cfg.n_heads * hd), p["wo"])


def _scatter_t(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
               ) -> None:
    """Write new [b, 1, n_kv, hd] into cache [b, n_kv, smax, hd] at
    per-batch positions pos [b], in place.  Callers keep ``pos < smax``
    (checked on the host by the serving loops): a CUDA index out of range
    is a device assert, not the reference's dropped write."""
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device), :, pos] = \
        new[:, 0].to(cache.dtype)


# ---------------------------------------------------------------------------
def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.compute_dtype
    if cfg.mlp_gated:
        return {"w_gate": Spec((d, f), dt), "w_up": Spec((d, f), dt),
                "w_down": Spec((f, d), dt)}
    return {"w_up": Spec((d, f), dt), "w_down": Spec((f, d), dt)}


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the reference's rounding points: its
    sigmoid is ``1 / (1 + exp(-x))``, each operation rounded to x's
    dtype (bit for bit ``jax.nn.silu`` in bf16 on the CPU; ``F.silu``
    rounds once and differs from it in a third of bf16 values)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    if "w_gate" in p:                                    # SwiGLU
        h = silu(torch.matmul(x, p["w_gate"]))
        h = h * torch.matmul(x, p["w_up"])
    else:                      # GELU, tanh form as jax.nn.gelu's default
        h = F.gelu(torch.matmul(x, p["w_up"]), approximate="tanh")
    return torch.matmul(h, p["w_down"])


def embed_specs(cfg: ArchConfig) -> Params:
    out = {"embedding": Spec((cfg.vocab, cfg.d_model), cfg.compute_dtype)}
    if not cfg.tie_embeddings:
        out["unembed"] = Spec((cfg.vocab, cfg.d_model), cfg.compute_dtype)
    return out


def embed(tokens: torch.Tensor, p: Params) -> torch.Tensor:
    return p["embedding"][tokens]


def unembed(x: torch.Tensor, p: Params) -> torch.Tensor:
    table = p.get("unembed", p["embedding"])
    return torch.matmul(x, table.T)

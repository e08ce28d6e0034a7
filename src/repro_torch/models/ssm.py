"""State-space blocks: Mamba-1 (selective scan, diagonal A) and Mamba-2
(SSD) — the counterpart of ``repro.models.ssm``.

* Mamba-1 — the chunked selective scan: a Python loop over sequence
  chunks, and inside a chunk the reference's ``associative_scan`` as a
  log-step (Hillis-Steele) scan over the chunk axis: step ``o = 1, 2, 4,
  ...`` does ``u[t] += a[t] * u[t - o]`` and ``a[t] *= a[t - o]``, six
  steps for a chunk of 64, each a few whole-tensor operations.  The
  decay tensors stay ``[b, chunk, d_inner, d_state]``.  (A cumulative
  sum of log decays and a division would overflow: ``exp(-la)`` grows
  without bound over a chunk.)
* Mamba-2 — the SSD block decomposition (intra-chunk attention-like term
  plus inter-chunk state passing), as batched products.

Both return their final states beside the output (``*_scan``), and both
have a one-step ``*_decode`` carrying ``(conv_state, ssm_state)``.  The
arithmetic and its rounding points follow the reference: projections in
the working dtype, the scans and the decode step in fp32.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import ArchConfig, Spec
from .layers import rms_norm, silu

Params = Dict[str, torch.Tensor]


def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.dt_rank or max(16, cfg.d_model // 16)


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba)
# ---------------------------------------------------------------------------
def mamba1_specs(cfg: ArchConfig) -> Params:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.d_state
    dtr = _dt_rank(cfg)
    dt = cfg.compute_dtype
    return {
        "in_proj": Spec((d, 2 * di), dt),
        "conv_w": Spec((cfg.conv_kernel, di), dt),
        "conv_b": Spec((di,), dt, init="zeros"),
        "x_proj": Spec((di, dtr + 2 * ds), dt),
        "dt_proj": Spec((dtr, di), dt),
        "dt_bias": Spec((di,), torch.float32, init="zeros"),
        "a_log": Spec((di, ds), torch.float32, init="small", scale=0.1),
        "d_skip": Spec((di,), torch.float32, init="ones"),
        "out_proj": Spec((di, d), dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over seq. x [b, s, c], w [k, c]; sums in
    fp32, the result in x's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def conv_tail(x: torch.Tensor, k: int) -> torch.Tensor:
    """The conv state after ``x [b, s, c]``: its last ``k - 1`` inputs,
    zeros before the first (what ``k - 1`` decode steps from a zero
    state leave)."""
    return F.pad(x, (0, 0, k - 1, 0))[:, -(k - 1):] if k > 1 else x[:, :0]


def _chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """[b, s, ...] zero-padded to a multiple of ``chunk`` and cut into
    ``[b, n_chunks, chunk, ...]``."""
    pad = (-t.shape[1]) % chunk
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, chunk, *t.shape[2:])


def _log_step_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``h[t] = a[t] * h[t - 1] + u[t]`` from ``h = 0``
    over dim 1, in ceil(log2(n)) steps; returns ``(a_cum, h)``."""
    n, o = a.shape[1], 1
    while o < n:
        u = torch.cat([u[:, :o], torch.addcmul(u[:, o:], a[:, o:],
                                               u[:, :-o])], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return a, u


def _mamba1_core(xc, dt, bmat, cmat, a, d_skip, h0, chunk: int):
    """Chunked selective scan.
    xc [b,s,di], dt [b,s,di] (softplus'd), bmat/cmat [b,s,ds], a [di,ds]
    (< 0), h0 [b,di,ds], all fp32.  Returns (y [b,s,di], h_final)."""
    s = xc.shape[1]
    xs, dts, bs, cs = (_chunks(t, chunk) for t in (xc, dt, bmat, cmat))
    h, ys = h0, []
    for c in range(xs.shape[1]):
        xck, dtk, bk, ck = xs[:, c], dts[:, c], bs[:, c], cs[:, c]
        decay = torch.exp(dtk[..., None] * a[None, None])  # [b,ck,di,ds]
        u = (dtk * xck)[..., None] * bk[:, :, None, :]      # [b,ck,di,ds]
        a_cum, u_cum = _log_step_scan(decay, u)
        hs = a_cum * h[:, None] + u_cum
        ys.append(torch.einsum("bcds,bcs->bcd", hs, ck))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    return y + xc * d_skip[None, None], h


def mamba1_scan(x: torch.Tensor, p: Params, cfg: ArchConfig,
                chunk: int = 64):
    """Prefill / forward over ``x [b, s, d]`` from a zero state:
    ``(y [b, s, d], conv_state [b, k-1, di], ssm_state [b, di, ds])``."""
    di, ds = cfg.d_inner, cfg.d_state
    dtr = _dt_rank(cfg)
    xz = torch.matmul(x, p["in_proj"])
    xc_raw, z = xz[..., :di], xz[..., di:]
    xc = silu(_causal_conv(xc_raw, p["conv_w"], p["conv_b"]))
    proj = torch.matmul(xc, p["x_proj"]).float()
    dt_low, bmat, cmat = (proj[..., :dtr], proj[..., dtr:dtr + ds],
                          proj[..., dtr + ds:])
    dt = F.softplus(torch.matmul(dt_low, p["dt_proj"].float())
                    + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    h0 = torch.zeros((x.shape[0], di, ds), dtype=torch.float32,
                     device=x.device)
    y, h = _mamba1_core(xc.float(), dt, bmat, cmat, a, p["d_skip"], h0,
                        chunk)
    y = y.to(x.dtype) * silu(z)
    return (torch.matmul(y, p["out_proj"]),
            conv_tail(xc_raw, cfg.conv_kernel), h)


def mamba1(x: torch.Tensor, p: Params, cfg: ArchConfig,
           chunk: int = 64) -> torch.Tensor:
    """Train / prefill forward. x [b, s, d] -> [b, s, d]."""
    return mamba1_scan(x, p, cfg, chunk)[0]


def _conv_step(conv_state, xc, w, b):
    """One step of the causal conv: ``(out [b, c] fp32, new_state)``."""
    window = torch.cat([conv_state, xc.to(conv_state.dtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()
    return out, window[:, 1:]


def mamba1_decode(x, p, cfg: ArchConfig, conv_state, ssm_state):
    """One token step. x [b, 1, d]; conv_state [b, k-1, di];
    ssm_state [b, di, ds] (fp32).  Returns (y [b, 1, d], conv, ssm)."""
    di, ds = cfg.d_inner, cfg.d_state
    dtr = _dt_rank(cfg)
    xz = torch.matmul(x, p["in_proj"])
    xc, z = xz[..., :di], xz[..., di:]
    xconv, new_conv = _conv_step(conv_state, xc, p["conv_w"], p["conv_b"])
    xc1 = silu(xconv)                                   # [b, di]
    proj = torch.matmul(xc1, p["x_proj"].float())
    dt_low, bvec, cvec = (proj[..., :dtr], proj[..., dtr:dtr + ds],
                          proj[..., dtr + ds:])
    dt = F.softplus(torch.matmul(dt_low, p["dt_proj"].float())
                    + p["dt_bias"])                       # [b, di]
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt[..., None] * a[None])            # [b, di, ds]
    h = decay * ssm_state + (dt * xc1)[..., None] * bvec[:, None, :]
    y = torch.einsum("bds,bs->bd", h, cvec) + xc1 * p["d_skip"][None]
    y = y.to(x.dtype)[:, None, :] * silu(z)
    return torch.matmul(y, p["out_proj"]), new_conv, h


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# ---------------------------------------------------------------------------
def mamba2_specs(cfg: ArchConfig) -> Params:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.d_state
    nh = di // cfg.ssm_head_dim
    dt = cfg.compute_dtype
    return {
        "in_proj": Spec((d, 2 * di + 2 * ds + nh), dt),
        "conv_w": Spec((cfg.conv_kernel, di + 2 * ds), dt),
        "conv_b": Spec((di + 2 * ds,), dt, init="zeros"),
        "a_log": Spec((nh,), torch.float32, init="small", scale=0.5),
        "dt_bias": Spec((nh,), torch.float32, init="zeros"),
        "d_skip": Spec((nh,), torch.float32, init="ones"),
        "norm_w": Spec((di,), dt, init="ones"),
        "out_proj": Spec((di, d), dt),
    }


def _ssd_core(xh, dt, bmat, cmat, a_log, h0, chunk: int):
    """SSD block decomposition.
    xh [b,s,H,hd], dt [b,s,H] (softplus'd), bmat/cmat [b,s,ds], a_log
    [H], h0 [b,H,hd,ds], all fp32.  Returns (y [b,s,H,hd], h_final)."""
    s = xh.shape[1]
    xs, dts, bs, cs = (_chunks(t, chunk) for t in (xh, dt, bmat, cmat))
    a = -torch.exp(a_log)                                  # [H] < 0
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))
    h, ys = h0, []
    for c in range(xs.shape[1]):
        xk, dtk, bk, ck = xs[:, c], dts[:, c], bs[:, c], cs[:, c]
        la = torch.cumsum(dtk * a[None, None], dim=1)     # [b,ck,H]
        # intra-chunk: att[i,j] = (C_i.B_j) exp(la_i - la_j) dt_j, j <= i
        cb = torch.einsum("bis,bjs->bij", ck, bk)
        ldiff = la[:, :, None, :] - la[:, None, :, :]     # [b,i,j,H]
        att = torch.where(causal[None, :, :, None],
                          cb[..., None] * torch.exp(ldiff),
                          torch.zeros((), device=xh.device))
        att = att * dtk[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhd->bihd", att, xk)
        # inter-chunk: y_i += exp(la_i) C_i . S_prev
        y_inter = torch.einsum("bis,bhds->bihd", ck, h) \
            * torch.exp(la)[..., None]
        # S_new = exp(la_end) S_prev + sum_j exp(la_end - la_j) dt_j x_j B_j^T
        w_j = torch.exp(la[:, -1:, :] - la) * dtk
        s_chunk = torch.einsum("bjh,bjhd,bjs->bhds", w_j, xk, bk)
        h = torch.exp(la[:, -1])[:, :, None, None] * h + s_chunk
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :s], h


def _mamba2_split(proj, cfg: ArchConfig):
    di, ds = cfg.d_inner, cfg.d_state
    z, rest = proj[..., :di], proj[..., di:]
    return z, rest[..., :di + 2 * ds], rest[..., di + 2 * ds:]


def mamba2_scan(x: torch.Tensor, p: Params, cfg: ArchConfig,
                chunk: int = 128):
    """Prefill / forward over ``x [b, s, d]`` from a zero state:
    ``(y [b, s, d], conv_state [b, k-1, di + 2 ds], ssm_state
    [b, H, hd, ds])``."""
    di, ds = cfg.d_inner, cfg.d_state
    hd = cfg.ssm_head_dim
    nh = di // hd
    z, xbc_raw, dt_raw = _mamba2_split(torch.matmul(x, p["in_proj"]), cfg)
    xbc = silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xc, bmat, cmat = (xbc[..., :di], xbc[..., di:di + ds],
                      xbc[..., di + ds:])
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    b, s, _ = x.shape
    xh = xc.float().reshape(b, s, nh, hd)
    h0 = torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    y, h = _ssd_core(xh, dt, bmat.float(), cmat.float(), p["a_log"], h0,
                     chunk)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * silu(z), p["norm_w"], cfg.norm_eps)
    return (torch.matmul(y, p["out_proj"]),
            conv_tail(xbc_raw, cfg.conv_kernel), h)


def mamba2(x: torch.Tensor, p: Params, cfg: ArchConfig,
           chunk: int = 128) -> torch.Tensor:
    return mamba2_scan(x, p, cfg, chunk)[0]


def mamba2_decode(x, p, cfg: ArchConfig, conv_state, ssm_state):
    """x [b,1,d]; conv_state [b,k-1,di+2ds]; ssm_state [b,H,hd,ds] fp32.
    Returns (y [b, 1, d], conv, ssm)."""
    di, ds = cfg.d_inner, cfg.d_state
    hd = cfg.ssm_head_dim
    nh = di // hd
    z, xbc, dt_raw = _mamba2_split(torch.matmul(x, p["in_proj"]), cfg)
    conv_out, new_conv = _conv_step(conv_state, xbc, p["conv_w"],
                                    p["conv_b"])
    xbc1 = silu(conv_out)
    xc, bvec, cvec = (xbc1[..., :di], xbc1[..., di:di + ds],
                      xbc1[..., di + ds:])
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # [b, H]
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a[None])                       # [b, H]
    xh = xc.reshape(-1, nh, hd)
    h = decay[:, :, None, None] * ssm_state \
        + (dt[:, :, None] * xh)[..., None] * bvec[:, None, None, :]
    y = torch.einsum("bhds,bs->bhd", h, cvec) \
        + xh * p["d_skip"][None, :, None]
    y = y.reshape(-1, 1, di).to(x.dtype)
    y = rms_norm(y * silu(z), p["norm_w"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"]), new_conv, h

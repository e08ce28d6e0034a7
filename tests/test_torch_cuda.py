"""Hand-written CUDA kernels vs their plain PyTorch twins, on the card.

Marked ``cuda``; each test asks the ``card`` fixture for the device, which
skips when no CUDA card is present (decided at run time, never at import,
so every pytest-xdist worker collects the same tests).  Run on a machine
with a card::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BallFilter, ComposeFilter, IntervalFilter
from repro_torch.core.workloads import (make_box_filter, make_compose_filter,
                                        make_dataset_device)
from repro_torch.kernels import ops
from repro_torch.kernels.distance import (pairwise_dist_call,
                                          pairwise_dist_plain)
from repro_torch.kernels.filtered_topk import (filtered_topk_call,
                                               filtered_topk_plain)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _data(card, n=3001, d=96, m=3, bq=29):
    x, s = make_dataset_device(n, d, m, seed=n, device=card)
    return x[:bq] + 0.05, x, s


def _tol(q, x):
    """fp32 tolerance on |q|^2 + |x|^2 (the kernel and the twin sum the
    products in different orders)."""
    return 1e-5 * ((q ** 2).sum(1) + (x ** 2).sum(1).max())[:, None]


_FILTERS = {
    "none": None,
    "box": make_box_filter(3, 0.3, seed=1),
    "ball": BallFilter(center=np.asarray([0.5, 0.5]), radius=0.35),
    "box_ball": ComposeFilter(BallFilter(center=np.asarray([0.5, 0.5]),
                                         radius=0.35),
                              IntervalFilter(dim=2, lo=0.1, hi=0.9), "and"),
    "box_not_ball": make_compose_filter(3, 0.3, seed=2),
}


@pytest.mark.parametrize("k", [10, 100, 300])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kind", list(_FILTERS))
def test_filtered_topk_kernel_matches_twin(card, kind, metric, k):
    q, x, s = _data(card)
    got_kind, params = ops.encode_filter(_FILTERS[kind], 3, mpad=3)
    assert got_kind == kind
    p = torch.as_tensor(params, device=card)[None]
    kpad = ops.next_pow2(max(k, 8))
    kd, ki = filtered_topk_call(q[None], x[None], s[None], p, kind, kpad,
                                metric)
    torch.cuda.synchronize()
    td, ti = filtered_topk_plain(q[None], x[None], s[None], p, kind, kpad,
                                 metric)
    fin = torch.isfinite(td)
    assert torch.equal(torch.isfinite(kd), fin)
    assert torch.equal(ki < 0, ~fin)
    tol = _tol(q, x)[None]
    assert bool((torch.where(fin, (kd - td).abs(), 0) <= tol).all())
    # ids agree where the distance is not an fp32 tie with a neighbour
    gap = td[..., 1:] - td[..., :-1]
    inf = torch.full_like(td[..., :1], float("inf"))
    uniq = fin & (torch.cat([inf, gap], -1) > 2 * tol) \
        & (torch.cat([gap, inf], -1) > 2 * tol)
    uniq[..., -1] = False
    assert torch.equal(ki[uniq], ti[uniq])


def test_filtered_topk_kernel_batch_axis(card):
    q, x, s = _data(card)
    p = torch.as_tensor(ops.encode_filter(_FILTERS["box"], 3, mpad=3)[1],
                        device=card)
    xs = torch.stack([x[:1500], x[1500:3000]])
    ss = torch.stack([s[:1500], s[1500:3000]])
    kd, ki = filtered_topk_call(q[None], xs, ss, p[None], "box", 16)
    for g in range(2):
        d1, i1 = filtered_topk_call(q[None], xs[g:g + 1], ss[g:g + 1],
                                    p[None], "box", 16)
        assert torch.equal(kd[g], d1[0]) and torch.equal(ki[g], i1[0])


def test_filtered_topk_kernel_counts_launches(card):
    import importlib
    b1 = importlib.import_module("repro_torch.kernels.filtered_topk")
    q, x, s = _data(card)
    before = b1.launch_count()
    ops.filtered_topk(q, x, s, None, 10)
    assert b1.launch_count() == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pairwise_dist_kernel_matches_twin(card, dtype, metric):
    q, x, _ = _data(card)
    q, x = q.to(dtype), x.to(dtype)
    got = pairwise_dist_call(q, x, metric)
    torch.cuda.synchronize()
    want = pairwise_dist_plain(q, x, metric)
    assert bool(((got - want).abs() <= _tol(q.float(), x.float())).all())


def _assert_topk_close(kd, ki, td, ti, tol):
    """Kernel lists (kd, ki) vs twin lists (td, ti): the same misses,
    distances within ``tol``, ids equal where the twin's distance is not
    an fp32 tie with a neighbour."""
    fin = torch.isfinite(td)
    assert torch.equal(torch.isfinite(kd), fin)
    assert torch.equal(ki < 0, ~fin)
    assert bool((torch.where(fin, (kd - td).abs(), 0) <= tol).all())
    gap = td[..., 1:] - td[..., :-1]
    inf = torch.full_like(td[..., :1], float("inf"))
    uniq = fin & (torch.cat([inf, gap], -1) > 2 * tol) \
        & (torch.cat([gap, inf], -1) > 2 * tol)
    uniq[..., -1] = False
    assert torch.equal(ki[uniq], ti[uniq])


def _shifted(t, offset):
    """A copy of ``t`` whose storage starts ``offset`` elements into its
    buffer, so its base pointer is off 16-byte alignment for offset > 0."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("layout", ["aligned", "row_view", "element"])
@pytest.mark.parametrize("d", [3, 130, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pairwise_dist_kernel_ragged_shapes(card, dtype, d, layout):
    """Batches and candidate counts that no tile divides, widths whose rows
    are not 16-byte multiples, and operands whose base pointer is off
    16-byte alignment (a row view ``x[1:]``, a storage offset of one
    element): every copy width of the mainloop against the twin."""
    from repro_torch.kernels.distance import launch_config
    x, _ = make_dataset_device(1301, d, 3, seed=d, device=card)
    q = (x[:150] + 0.05).to(dtype)
    x = x.to(dtype)
    if layout == "row_view":
        x = x[1:]
    elif layout == "element":
        q, x = _shifted(q, 1), _shifted(x, 1)
    cfg = launch_config(q.shape[0], x.shape[0], d, dtype, q.data_ptr(),
                        x.data_ptr())
    if layout == "element":
        assert cfg["vec_x"] < 16 and cfg["vec_q"] < 16
    for metric in ("l2", "ip"):
        got = pairwise_dist_call(q, x, metric)
        torch.cuda.synchronize()
        want = pairwise_dist_plain(q, x, metric)
        assert got.shape == (150, x.shape[0])
        assert bool(((got - want).abs()
                     <= _tol(q.float(), x.float())).all())


def _quant_stack(card, g=3, cap=1200, d=96, m=3):
    """Ragged int8 shard stacks (codes, metadata, xsq, scales) and their
    dequantized rows, from the same data as ``_data``."""
    from repro_torch.quant import dequantize, encode_segment
    q, x, s = _data(card)
    codes = torch.zeros((g, cap, d), dtype=torch.int8, device=card)
    ss = torch.full((g, cap, m), ops.PAD_META, device=card)
    xsq = torch.zeros((g, cap), device=card)
    scales = torch.zeros((g, d), device=card)
    deq = torch.zeros((g, cap, d), device=card)
    for gi, fill in enumerate((cap, 1000, 333)):
        lo = gi * 900
        sq = encode_segment(x[lo:lo + fill].cpu().numpy())
        codes[gi, :fill] = torch.as_tensor(sq.codes, device=card)
        ss[gi, :fill] = s[lo:lo + fill]
        xsq[gi, :fill] = torch.as_tensor(sq.xsq, device=card)
        scales[gi] = torch.as_tensor(sq.scales, device=card)
        deq[gi, :fill] = torch.as_tensor(dequantize(sq.codes, sq.scales),
                                         device=card)
    return q, codes, ss, xsq, scales, deq


@pytest.mark.parametrize("kpad", [16, 512, 2048])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kind", list(_FILTERS))
def test_quant_topk_kernel_matches_twin(card, kind, metric, kpad):
    from repro_torch.kernels.quant_topk import (quant_topk_call,
                                                quant_topk_plain)
    q, codes, ss, xsq, scales, deq = _quant_stack(card)
    qs = q[None] * scales[:, None, :]
    params = torch.as_tensor(ops.encode_filter(_FILTERS[kind], 3,
                                               mpad=3)[1], device=card)
    kd, ki = quant_topk_call(qs, codes, ss, xsq, params, kind, kpad, metric)
    torch.cuda.synchronize()
    td, ti = quant_topk_plain(qs, codes, ss, xsq, params, kind, kpad,
                              metric)
    fin = torch.isfinite(td)
    assert torch.equal(torch.isfinite(kd), fin)
    assert torch.equal(ki < 0, ~fin)
    tol = _tol(q, deq.reshape(-1, deq.shape[-1]))[None]
    assert bool((torch.where(fin, (kd - td).abs(), 0) <= tol).all())
    gap = td[..., 1:] - td[..., :-1]
    inf = torch.full_like(td[..., :1], float("inf"))
    uniq = fin & (torch.cat([inf, gap], -1) > 2 * tol) \
        & (torch.cat([gap, inf], -1) > 2 * tol)
    uniq[..., -1] = False
    assert torch.equal(ki[uniq], ti[uniq])


@pytest.mark.parametrize("d", [96, 130])
@pytest.mark.parametrize("kpad", [16, 64, 256, 2048])
def test_quant_topk_kernel_skips_failing_tiles(card, kpad, d):
    """A stack where whole candidate tiles fail the predicate: row 1 is
    all ``PAD_META``, rows 0 and 2 are time-ordered and the interval
    t >= 0.55 rejects their first halves.  The codes of every failing
    candidate are replaced by random bytes: the kernel's answer must not
    change (bit for bit) and must equal the twin's on the clean stack."""
    from repro_torch.core import IntervalFilter
    from repro_torch.kernels.quant_topk import (live_tiles, quant_topk_call,
                                                quant_topk_plain)
    from repro_torch.kernels.ref import filter_mask_ref
    from repro_torch.quant import encode_segment
    g, cap, m = 3, 1200, 3
    x, s = make_dataset_device(g * cap, d, m, seed=kpad + d, device=card)
    q = x[:37] + 0.05
    sq = encode_segment(x.cpu().numpy())
    codes = torch.as_tensor(sq.codes, device=card).reshape(g, cap, d)
    scales = torch.as_tensor(sq.scales, device=card)[None].expand(g, d)
    xsq = torch.as_tensor(sq.xsq, device=card).reshape(g, cap)
    ss = s.reshape(g, cap, m).clone()
    ss[:, :, 2] = torch.arange(cap, device=card) / cap       # event time
    ss[1] = ops.PAD_META
    kind, params = ops.encode_filter(IntervalFilter(dim=2, lo=0.55), m,
                                     mpad=m)
    params = torch.as_tensor(params, device=card)
    _, live, tiles = live_tiles(ss, params, kind)
    assert 0 < live < tiles - 8       # whole tiles of rows 0 and 2 fail
    ok = filter_mask_ref(ss, kind, params)
    gen = torch.Generator(device=card)
    gen.manual_seed(kpad)
    noise = torch.randint(-128, 128, codes.shape, generator=gen,
                          device=card, dtype=torch.int8)
    dirty = torch.where(ok[..., None], codes, noise)
    qs = (q[None] * scales[:, None, :]).contiguous()
    for metric in ("l2", "ip"):
        kd, ki = quant_topk_call(qs, dirty, ss, xsq, params, kind, kpad,
                                 metric)
        cd, ci = quant_topk_call(qs, codes, ss, xsq, params, kind, kpad,
                                 metric)
        torch.cuda.synchronize()
        assert torch.equal(kd, cd) and torch.equal(ki, ci)
        td, ti = quant_topk_plain(qs, codes, ss, xsq, params, kind, kpad,
                                  metric)
        deq = codes.float() * scales[:, None, :]
        _assert_topk_close(kd, ki, td, ti,
                           _tol(q, deq.reshape(-1, d))[None])


@pytest.mark.parametrize("d", [96, 130, 768])
@pytest.mark.parametrize("kpad", [16, 128, 1024])
def test_filtered_topk_kernel_skips_failing_tiles(card, kpad, d):
    """B1 on a time-ordered stack where whole candidate tiles fail: row 1
    is all ``PAD_META``, row 2 ends in a ragged ``PAD_META`` tail, and the
    interval t >= 0.55 rejects the first halves of the rows.  The vectors
    of every failing candidate are replaced by random values (large ones,
    so a norm that leaks from one live tile into the next, or a product of
    a skipped tile, would show): the answer must not change, bit for bit,
    and must equal the twin's on the clean stack."""
    from repro_torch.kernels.filtered_topk import launch_config
    from repro_torch.kernels.quant_topk import live_tiles
    from repro_torch.kernels.ref import filter_mask_ref
    g, cap, m = 3, 1200, 3
    x, s = make_dataset_device(g * cap, d, m, seed=kpad + d, device=card)
    q = x[:37] + 0.05
    xs = x.reshape(g, cap, d)
    ss = s.reshape(g, cap, m).clone()
    ss[:, :, 2] = torch.arange(cap, device=card) / cap       # event time
    ss[1] = ops.PAD_META
    ss[2, cap - 77:] = ops.PAD_META
    kind, params = ops.encode_filter(IntervalFilter(dim=2, lo=0.55), m,
                                     mpad=m)
    params = torch.as_tensor(params, device=card)
    _, live, tiles = live_tiles(ss, params, kind)
    assert 0 < live < tiles - 8       # whole tiles of every row fail
    cfg = launch_config(g, q.shape[0], cap, d, kpad, q.data_ptr(),
                        xs.data_ptr(), 132)
    assert cfg["vec_x"] == (16 if d % 4 == 0 else 4)
    ok = filter_mask_ref(ss, kind, params)
    gen = torch.Generator(device=card)
    gen.manual_seed(kpad + d)
    noise = 100 * torch.randn(xs.shape, generator=gen, device=card)
    dirty = torch.where(ok[..., None], xs, noise)
    p = params[None]
    for metric in ("l2", "ip"):
        kd, ki = filtered_topk_call(q[None], dirty, ss, p, kind, kpad,
                                    metric)
        cd, ci = filtered_topk_call(q[None], xs, ss, p, kind, kpad, metric)
        torch.cuda.synchronize()
        assert torch.equal(kd, cd) and torch.equal(ki, ci)
        td, ti = filtered_topk_plain(q[None], xs, ss, p, kind, kpad, metric)
        _assert_topk_close(kd, ki, td, ti, _tol(q, x)[None])


def _sparse_lanes(pos, seed):
    """About 80% of ``pos`` set to -1 the way a traversal's fresh mask
    leaves it: whole query rows (so whole blocks of tq queries), a run of
    64 lanes in every row (whole warps of the compaction) and scattered
    lanes elsewhere."""
    gen = torch.Generator(device=pos.device)
    gen.manual_seed(seed)
    keep = torch.rand(pos.shape, generator=gen, device=pos.device) < 0.4
    keep[:10] = False
    keep[:, 32:96] = False
    return torch.where(keep, pos, -1)


def _check_hop(q, pos, block, ss, params, kind, metric, sc, deq, lanes):
    """B4 vs its twin on one hop: equal masks, +inf at -1 lanes, distances
    within the fp32 tolerance.  On sparse lanes the kernel must also give
    the live lanes bit for bit what it gives them among dense lanes (the
    order of a sum depends only on d)."""
    from repro_torch.kernels.graph_topk import (beam_step_plain,
                                                beam_step_scores)
    dense = pos
    if lanes == "sparse":
        pos = _sparse_lanes(pos, pos.shape[1])
        assert 0.7 < float((pos < 0).float().mean()) < 0.92
    kd, kok = beam_step_scores(q, pos, block, ss, params, kind, metric,
                               scales=sc)
    torch.cuda.synchronize()
    td, tok = beam_step_plain(q, pos, block, ss, params, kind, metric,
                              scales=sc)
    valid = pos >= 0
    assert torch.equal(kok, tok)
    assert bool(torch.isinf(kd[~valid]).all())
    tol = _tol(q, deq.reshape(-1, block.shape[-1]))
    assert bool((torch.where(valid, (kd - td).abs(), 0) <= tol).all())
    if lanes == "sparse":
        fd, fok = beam_step_scores(q, dense, block, ss, params, kind,
                                   metric, scales=sc)
        assert torch.equal(kd[valid], fd[valid])
        assert torch.equal(kok[valid], fok[valid])


@pytest.mark.parametrize("lanes", ["all", "sparse"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kind", list(_FILTERS))
def test_graph_step_kernel_matches_twin(card, kind, metric, quantized,
                                        lanes):
    """c = 1100 lanes: more than one chunk of 1024 a block compacts at
    once, and not a multiple of a warp."""
    q, codes, ss, xsq, scales, deq = _quant_stack(card)
    g, cap, d = codes.shape
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    pos = torch.randint(-1, g * cap, (q.shape[0], 1100), generator=gen,
                        device=card, dtype=torch.int32)
    block, sc = (codes, scales) if quantized else (deq, None)
    params = torch.as_tensor(ops.encode_filter(_FILTERS[kind], 3,
                                               mpad=3)[1], device=card)
    _check_hop(q, pos, block, ss, params, kind, metric, sc, deq, lanes)


@pytest.mark.parametrize("lanes", ["all", "sparse"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d,g", [(3, 2), (30, 2), (130, 2), (768, 24)])
def test_graph_step_kernel_matches_twin_unaligned_width(card, d, g,
                                                        quantized, lanes):
    """Widths with d % 4 != 0 (d % 16 != 0 for int8) take B4's element
    loads and a short tail piece; d = 768 over 24 rows has int8 scales
    (72 KB) too large for the shared-memory stage, so they are read from
    global memory.  All must score like the twin."""
    from repro_torch.kernels.graph_topk import launch_config
    from repro_torch.quant import dequantize, encode_segment
    cap, m = (700 if g == 2 else 64), 3
    x, s = make_dataset_device(g * cap, d, m, seed=d, device=card)
    q = x[:17] + 0.05
    codes = torch.empty((g, cap, d), dtype=torch.int8, device=card)
    scales = torch.empty((g, d), device=card)
    deq = torch.empty((g, cap, d), device=card)
    xr = x.reshape(g, cap, d)
    for r in range(g):
        sq = encode_segment(xr[r].cpu().numpy())
        codes[r] = torch.as_tensor(sq.codes, device=card)
        scales[r] = torch.as_tensor(sq.scales, device=card)
        deq[r] = torch.as_tensor(dequantize(sq.codes, sq.scales),
                                 device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(d)
    pos = torch.randint(-1, g * cap, (q.shape[0], 200), generator=gen,
                        device=card, dtype=torch.int32)
    block, sc = (codes, scales) if quantized else (deq, None)
    cfg = launch_config(17, d, g, quantized, block.data_ptr(),
                        scales.data_ptr())
    assert cfg["stage"] == int(quantized and g * d * 4 <= 64 * 1024)
    assert cfg["vec"] == int(d % (16 if quantized else 4) == 0)
    ss = s.reshape(g, cap, m)
    params = torch.as_tensor(ops.encode_filter(_FILTERS["box"], 3,
                                               mpad=3)[1], device=card)
    _check_hop(q, pos, block, ss, params, "box", "l2", sc, deq, lanes)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_sharded_pack_invariants_on_card(card, quantize):
    """On the card: the bucketed pack answers bit for bit like the
    monolithic scan (fp32) and like a cold rebuild after mutations."""
    from repro_torch.distributed import segment_shards as tss
    rng = np.random.default_rng(1)
    srcs, gid0 = [], 0
    for sid in range(4):
        n = int(rng.integers(300, 900))
        x = rng.normal(size=(n, 64)).astype(np.float32)
        s = rng.uniform(size=(n, 3))
        srcs.append(tss.SegmentShardSource(
            sid, x, s, np.arange(gid0, gid0 + n, dtype=np.int64),
            float(s[:, 2].min()), float(s[:, 2].max())))
        gid0 += n
    lookup_x = np.concatenate([src.x for src in srcs])
    lookup = lambda g: (lookup_x[np.asarray(g)], None,  # noqa: E731
                        np.ones(len(g), bool))
    q = rng.normal(size=(16, 64)).astype(np.float32)
    inc = tss.BucketedShardPack(2, 64, 3, quantize=quantize, device=card)
    for src in srcs:
        inc.add_segment(src)
    assert inc.remove_segment(1)
    inc.add_segment(srcs[1])
    dead = rng.choice(gid0, 100, replace=False)
    inc.mark_dead(dead)
    cold = tss.build_bucketed_pack(srcs, 2, quantize=quantize, device=card)
    cold.mark_dead(dead)
    kw = dict(lookup=lookup) if quantize else {}
    gi, di = tss.pack_search(inc, q, None, k=20, **kw)
    gc, dc = tss.pack_search(cold, q, None, k=20, **kw)
    assert np.array_equal(di, dc) and np.array_equal(gi, gc)
    if quantize is None:
        mono = tss.build_shard_pack(srcs, 3, device=card)
        mono.mark_dead(dead)
        gm, dm = tss.pack_search(mono, q, None, k=20)
        assert np.array_equal(di, dm)


def _card_pack(card, quantize, rng, n_segs=4, d=64):
    from repro_torch.distributed import segment_shards as tss
    srcs, gid0 = [], 0
    for sid in range(n_segs):
        n = int(rng.integers(300, 900))
        x = rng.normal(size=(n, d)).astype(np.float32)
        s = rng.uniform(size=(n, 3))
        srcs.append(tss.SegmentShardSource(
            sid, x, s, np.arange(gid0, gid0 + n, dtype=np.int64),
            float(s[:, 2].min()), float(s[:, 2].max())))
        gid0 += n
    return tss.build_bucketed_pack(srcs, 2, quantize=quantize, device=card)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_scan_kernels_deterministic_whatever_passes(card, quantize):
    """B1 / B3 at a fixed shape: a candidate's distance does not depend on
    which other candidates pass the filter (pass 1 packs only passing
    candidates, so the packing order changes) nor on the launch — the
    property cold dispatches rely on to answer bit for bit."""
    from repro_torch.distributed import segment_shards as tss
    pack = _card_pack(card, quantize, np.random.default_rng(3))
    q = np.random.default_rng(4).normal(size=(24, 64)).astype(np.float32)
    seen = {}
    for filt in (None, _FILTERS["box"], _FILTERS["box_not_ball"],
                 _FILTERS["box"]):
        for bv in pack.view().buckets:
            if quantize:
                ids, dd = ops.sharded_quant_filtered_topk(
                    torch.as_tensor(q, device=card), bv.block("codes"),
                    bv.block("s"), bv.block("xsq"), bv.block("scales"), filt,
                    64)
            else:
                ids, dd = ops.sharded_filtered_topk(
                    torch.as_tensor(q, device=card), bv.block("x"),
                    bv.block("s"), filt, 64)
            g = torch.gather(bv.block("gids").long(), 1,
                             ids.long().clamp_min(0).reshape(
                                 ids.shape[0], -1)).reshape(ids.shape)
            g, d = g.cpu().numpy(), dd.cpu().numpy()
            row = np.broadcast_to(np.arange(24)[None, :, None], g.shape)
            ok = (ids.cpu().numpy() >= 0) & np.isfinite(d)
            for key, val in zip(zip(row[ok].tolist(), g[ok].tolist()),
                                d[ok].tolist()):
                assert seen.setdefault(key, val) == val, key


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_cold_bucket_answers_equal_resident_on_card(card, quantize):
    """Every bucket evicted to page-locked host memory: the cold dispatch
    copies each block to the card and launches B1 (fp32) or B3 (int8),
    and the answers equal the resident ones bit for bit."""
    import importlib
    from repro_torch.distributed import segment_shards as tss
    mod = importlib.import_module("repro_torch.kernels." + (
        "quant_topk" if quantize else "filtered_topk"))
    rng = np.random.default_rng(5)
    pack = _card_pack(card, quantize, rng)
    q = rng.normal(size=(16, 64)).astype(np.float32)
    for filt in (None, _FILTERS["box"]):
        hot = tss.pack_search_blocks(pack.view(), q, filt, 40)
        for cap in list(pack.buckets):
            pack.evict_bucket(cap)
        assert pack.nbytes == 0 and pack.host_nbytes > 0
        view = pack.view()
        assert all(not bv.resident and bv.block("s").is_pinned()
                   for bv in view.buckets)
        before = mod.launch_count()
        cold = tss.pack_search_blocks(view, q, filt, 40)
        assert mod.launch_count() - before == len(view.buckets)
        for (ga, da), (gb, db) in zip(hot, cold):
            assert np.array_equal(ga, gb) and np.array_equal(da, db)
        for cap in list(pack.buckets):
            assert pack.admit_bucket(cap) > 0


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_side_stream_admission_on_card(card, quantize):
    """An admission uploaded on the side stream (an event at its end) and
    installed under the lock: the consuming stream waits on the event and
    the resident answers come back unchanged."""
    from repro_torch.distributed import segment_shards as tss
    rng = np.random.default_rng(6)
    pack = _card_pack(card, quantize, rng)
    q = rng.normal(size=(16, 64)).astype(np.float32)
    hot = tss.pack_search_blocks(pack.view(), q, _FILTERS["box"], 40)
    caps = list(pack.buckets)
    for cap in caps:
        pack.evict_bucket(cap)
    ups = [(cap, pack.upload_admission(pack.stage_admission(cap)))
           for cap in caps]
    for cap, (gen, up) in ups:
        assert up.events is not None
        assert all(p.device.type == "cuda" for t in up.blk.values()
                   for p in t)
        assert pack.install_admission(cap, gen, up) > 0
        assert pack.buckets[cap].resident
    again = tss.pack_search_blocks(pack.view(), q, _FILTERS["box"], 40)
    for (ga, da), (gb, db) in zip(hot, again):
        assert np.array_equal(ga, gb) and np.array_equal(da, db)


def test_restore_onto_card_equals_original(card, tmp_path):
    """A manager snapshotted and restored onto the card answers every read
    path bit for bit like the original, under a budget too."""
    import dataclasses
    from repro_torch.core import CubeGraphConfig
    from repro_torch.streaming import SegmentManager, StreamConfig
    rng = np.random.default_rng(7)
    for quantize in (None, "int8"):
        cfg = StreamConfig(time_dim=2, seal_max_points=400, n_shards=2,
                           read_path="auto", quantize=quantize,
                           index_cfg=CubeGraphConfig(n_layers=2, m_intra=8,
                                                     m_cross=2))
        mgr = SegmentManager(32, 3, cfg, device=card)
        x = rng.normal(size=(2000, 32)).astype(np.float32)
        s = rng.uniform(size=(2000, 3))
        s[:, 2] = np.arange(2000) / 2000
        mgr.ingest(x, s)
        mgr.delete(rng.integers(0, 2000, 100))
        snap = str(tmp_path / f"snap-{quantize}")
        mgr.snapshot_to(snap)
        q = rng.normal(size=(32, 32)).astype(np.float32)
        base = mgr.query(q, _FILTERS["box"], k=10, read_path="scan")
        budget = max(mgr.stats()["pack_nbytes"] // 3, 1)
        for over in ({}, {"device_budget_bytes": budget}):
            r = SegmentManager.restore(
                snap, cfg=dataclasses.replace(cfg, **over), device=card,
                resume=False)
            assert r.device == card
            for rp in ("scan", "graph", "auto"):
                ga, da = mgr.query(q, _FILTERS["box"], k=10, read_path=rp)
                gb, db = r.query(q, _FILTERS["box"], k=10, read_path=rp)
                if over and rp == "auto":
                    continue            # residency may change the plan
                assert np.array_equal(ga, gb) and np.array_equal(da, db)
            if over:
                gb, db = r.query(q, _FILTERS["box"], k=10, read_path="scan")
                assert np.array_equal(base[0], gb)
                assert np.array_equal(base[1], db)
                assert r.stats()["tier"]["resident_bytes"] <= budget


def test_mesh_over_every_card_equals_one_card(card):
    """A shard mesh over every visible card (two entries on the one card
    where only one is visible) answers fp32 and int8 managers' scan,
    graph and auto reads, and a grouped flush, bit for bit like one card,
    and launches B1, B3 and B4 on each card of the mesh."""
    import importlib
    from repro_torch.core import CubeGraphConfig
    from repro_torch.distributed import ShardMesh, make_shard_mesh
    from repro_torch.streaming import SegmentManager, StreamConfig
    from repro_torch.streaming.query import GroupQuery
    n = torch.cuda.device_count()
    mesh = ShardMesh((card,) * 2) if n == 1 else make_shard_mesh()
    assert mesh.home == card
    mods = {name: importlib.import_module("repro_torch.kernels." + name)
            for name in ("filtered_topk", "quant_topk", "graph_topk")}
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3000, 32)).astype(np.float32)
    s = rng.uniform(size=(3000, 3))
    s[:, 2] = np.arange(3000) / 3000
    q = rng.normal(size=(24, 32)).astype(np.float32)
    for quantize in (None, "int8"):
        cfg = StreamConfig(time_dim=2, seal_max_points=400, n_shards=3,
                           read_path="auto", quantize=quantize,
                           index_cfg=CubeGraphConfig(n_layers=2, m_intra=8,
                                                     m_cross=2))
        one = SegmentManager(32, 3, cfg, device=card)
        many = SegmentManager(32, 3, cfg, shard_mesh=mesh)
        for mgr in (one, many):
            mgr.ingest(x, s)
            mgr.delete(np.arange(0, 3000, 11))
        for m in mods.values():
            m.reset_launch_count()
        for filt in (None, _FILTERS["box"]):
            for rp in ("scan", "graph", "auto"):
                ga, da = many.query(q, filt, k=10, read_path=rp)
                gb, db = one.query(q, filt, k=10, read_path=rp)
                assert np.array_equal(ga, gb) and np.array_equal(da, db)
        used = ("quant_topk" if quantize else "filtered_topk", "graph_topk")
        for name in used:
            per = mods[name].launch_counts_by_device()
            assert all(per.get(d.index, 0) > 0 for d in mesh.devices), \
                (name, per)
        if quantize is None:
            groups = [GroupQuery(q[:8], None, 10),
                      GroupQuery(q[8:], _FILTERS["box"], 7)]
            for a, b in zip(many.query_grouped(groups),
                            one.query_grouped(groups)):
                assert np.array_equal(a[0], b[0])
                assert np.array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# Kernel B5: decode attention
# ---------------------------------------------------------------------------
def _decode_inputs(card, bkv, g, smax, hd, dtype, seed):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=card).to(dtype)
               for shape in ((bkv, g, hd), (bkv, smax, hd), (bkv, smax, hd)))
    lengths = torch.randint(0, smax, (bkv,), generator=gen, device=card,
                            dtype=torch.int32)
    lengths[0] = 0
    lengths[-1] = smax - 1
    return q, k, v, lengths


def _decode_close(got, want):
    """Kernel and twin both accumulate in fp32 and round the output once:
    fp32 within 2e-4 (the reference's kernel-test bound), bf16 within
    1e-2 absolute + relative (two bf16 ulps at |o| ~ 1)."""
    tol = 2e-4 if want.dtype == torch.float32 else 1e-2
    g, w = got.float(), want.float()
    return got.dtype == want.dtype and bool(
        ((g - w).abs() <= tol + tol * w.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 2, 8, 12, 16])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_flash_decode_kernel_matches_twin(card, dtype, g, hd):
    from repro_torch.kernels.flash_decode import (flash_decode_call,
                                                  flash_decode_plain)
    smax = 1000 + 37 * g              # ragged: no tile divides it
    args = _decode_inputs(card, 5, g, smax, hd, dtype, g * 1000 + hd)
    got = flash_decode_call(*args)
    torch.cuda.synchronize()
    assert _decode_close(got, flash_decode_plain(*args))


@pytest.mark.parametrize("bkv,smax", [(600, 50), (1, 5000), (64, 4096)])
def test_flash_decode_kernel_split_counts(card, bkv, smax):
    """One split per row (many rows), many splits (one row), and the
    batcher tick's shape; each call counts one launch."""
    from repro_torch.kernels import flash_decode as fd
    args = _decode_inputs(card, bkv, 2, smax, 128, torch.bfloat16, bkv)
    before = fd.launch_count()
    got = fd.flash_decode_call(*args)
    torch.cuda.synchronize()
    assert fd.launch_count() == before + 1
    assert _decode_close(got, fd.flash_decode_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_flash_decode_kernel_ragged_lengths(card, dtype, hd):
    """96 rows holding 1, 2, one tile + 1, four tiles, four tiles + 1 and
    smax keys (inclusive lengths 0, 1, tile, 4 tiles - 1, 4 tiles,
    smax - 1, in turn) in one call, for every group size the kernel is
    compiled for and one it rounds up (3).  The rows' tiles outnumber the
    grid, so block ranges cross row boundaries and long rows are cut into
    segments that the fused combine joins.  The call runs twice in a row:
    the combine's per-row counters must be left at 0, so the second answer
    equals the first bit for bit."""
    from repro_torch.kernels.flash_decode import (flash_decode_call,
                                                  flash_decode_plain,
                                                  launch_config)
    bkv, smax = 96, 2000
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for g in (1, 2, 3, 8, 16):
        cfg = launch_config(bkv, g, smax, hd, dtype, sms)
        ts = cfg["tile"]
        pattern = [0, 1, ts, 4 * ts - 1, 4 * ts, smax - 1]
        lengths = torch.tensor([pattern[i % 6] for i in range(bkv)],
                               dtype=torch.int32, device=card)
        tiles = int(((lengths.long() + ts) // ts).sum())
        assert tiles > cfg["blocks"]
        q, k, v, _ = _decode_inputs(card, bkv, g, smax, hd, dtype, hd + g)
        first = flash_decode_call(q, k, v, lengths)
        second = flash_decode_call(q, k, v, lengths)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        assert _decode_close(first, flash_decode_plain(q, k, v, lengths))


@pytest.mark.parametrize("window", [0, 5, 70, 512, 5000])
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_window_matches_twin(card, dtype, hd, window):
    """Windowed rows (window 0, one that starts inside a tile, gemma3's
    512, one longer than every prefix) beside lengths 0, 1, a tile, four
    tiles - 1, four tiles and smax - 1, for groups 1, 4 and 16: the
    kernel reads only the window's tiles and masks the first one's keys
    before the window; two calls in a row agree bit for bit, and each
    counts one windowed launch."""
    from repro_torch.kernels import flash_decode as fd
    bkv, smax = 96, 2000
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for g in (1, 4, 16):
        ts = fd.launch_config(bkv, g, smax, hd, dtype, sms)["tile"]
        pattern = [0, 1, ts, 4 * ts - 1, 4 * ts, smax - 1]
        lengths = torch.tensor([pattern[i % 6] for i in range(bkv)],
                               dtype=torch.int32, device=card)
        q, k, v, _ = _decode_inputs(card, bkv, g, smax, hd, dtype,
                                    hd + g + window)
        before = fd.windowed_launch_count()
        first = fd.flash_decode_call(q, k, v, lengths, window)
        second = fd.flash_decode_call(q, k, v, lengths, window)
        torch.cuda.synchronize()
        assert fd.windowed_launch_count() == before + 2
        assert torch.equal(first, second)
        assert _decode_close(first, fd.flash_decode_plain(q, k, v, lengths,
                                                          window))


@pytest.mark.parametrize("case", ["hd", "g", "dtype", "contiguous"])
def test_flash_decode_kernel_refuses_what_it_cannot_take(card, case):
    from repro_torch.kernels.flash_decode import flash_decode_call
    q, k, v, ln = _decode_inputs(card, 4, 2, 64, 64, torch.float32, 3)
    args = {
        "hd": lambda: _decode_inputs(card, 4, 2, 64, 96, torch.float32, 3),
        "g": lambda: _decode_inputs(card, 4, 17, 64, 64, torch.float32, 3),
        "dtype": lambda: (q.half(), k.half(), v.half(), ln),
        "contiguous": lambda: (q, k.transpose(1, 2).contiguous()
                               .transpose(1, 2), v, ln),
    }[case]()
    with pytest.raises((ValueError, TypeError)):
        flash_decode_call(*args)


def test_decode_step_through_b5_matches_cpu(card):
    """One prefill and two decode steps with ragged positions of a small
    fp32 config (hd = 64, GQA group 2) on the card, where each layer's
    attention is a B5 launch, against the same steps on CPU tensors (the
    twin): logits and cache within 1e-4 (fp32 everywhere, TF32 off; only
    the summation order differs)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import build_model, init_params
    cfg = dataclasses.replace(get_config("internvl2-2b", smoke=True),
                              head_dim=64, n_patches=0, dtype="float32")
    model = build_model(cfg)
    cpu_p = init_params(model.param_specs(), seed=0, device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(card)
                for k, v in tree.items()}
    gpu_p = to(cpu_p)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 11))
    out = {}
    for name, dev, p in (("cpu", torch.device("cpu"), cpu_p),
                         ("card", card, gpu_p)):
        cache = model.init_cache(2, 40, device=dev)
        model.prefill(p, toks, cache)
        pos = torch.as_tensor([11, 17])
        before = fd.launch_count()
        for step in range(2):
            lg, cache = model.decode_step(p, [[3], [5 + step]], cache, pos)
            pos = pos + 1
        launched = fd.launch_count() - before
        out[name] = (lg.cpu(), cache["k"].cpu(), cache["v"].cpu(), launched)
    assert out["cpu"][3] == 0 and out["card"][3] == 2 * cfg.n_layers
    for a, b in zip(out["cpu"][:3], out["card"][:3]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# B1's grouped launch (the serving tier) and a chaos tape on the card
# ---------------------------------------------------------------------------
def _grouped_inputs(card, G, S, n, d, bq, seed, kind_filters):
    x, s = make_dataset_device(S * n, d, 3, seed=seed, device=card)
    xs, ss = x.reshape(S, n, d), s.reshape(S, n, 3)
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    q = torch.randn((G, bq, d), generator=gen, device=card)
    params = torch.stack([torch.as_tensor(
        ops.encode_filter(f, 3, mpad=3)[1], device=card)
        for f in kind_filters])
    return q, xs, ss, params


def test_grouped_filtered_topk_matches_twin(card):
    """The grouped launch against its twin (each group's plain twin over
    the shard stack), both query layouts."""
    from repro_torch.kernels.filtered_topk import (
        filtered_topk_grouped_call, filtered_topk_grouped_plain)
    boxes = [make_box_filter(3, r, seed=i) for i, r in
             enumerate((0.1, 0.3, 0.6, 0.9))]
    q, xs, ss, p = _grouped_inputs(card, 4, 3, 2000, 96, 21, 5, boxes)
    q4 = q[:, None].expand(4, 3, 21, 96).contiguous() + 0.01
    for qq in (q, q4):
        for metric in ("l2", "ip"):
            kd, ki = filtered_topk_grouped_call(qq, xs, ss, p, "box", 32,
                                                metric)
            torch.cuda.synchronize()
            td, ti = filtered_topk_grouped_plain(qq, xs, ss, p, "box", 32,
                                                 metric)
            assert kd.shape == (4, 3, 21, 32)
            qf = qq.reshape(-1, 96)
            tol = _tol(qf, xs.reshape(-1, 96)).max()
            _assert_topk_close(kd.reshape(-1, 21, 32), ki.reshape(-1, 21, 32),
                               td.reshape(-1, 21, 32), ti.reshape(-1, 21, 32),
                               tol)


@pytest.mark.parametrize("n", [3000, 20000])
def test_grouped_filtered_topk_equals_solo_launches(card, n):
    """``sharded_filtered_topk_grouped`` on the card: two filter classes
    (box kpad 16, ball kpad 32), uneven group row counts, a singleton and
    an unfiltered group — every group bit for bit its solo launch, where
    the grouped launch's candidate splits differ from the solo one's."""
    import importlib
    from repro_torch.kernels.filtered_topk import launch_config
    b1 = importlib.import_module("repro_torch.kernels.filtered_topk")
    S, d = 2, 96
    x, s = make_dataset_device(S * n, d, 3, seed=n, device=card)
    xs, ss = x.reshape(S, n, d), s.reshape(S, n, 3)
    gen = torch.Generator(device=card)
    gen.manual_seed(n)
    ball = BallFilter(center=np.asarray([0.5, 0.5]), radius=0.3)
    specs = [(3, make_box_filter(3, 0.3, seed=1), 10),
             (200, make_box_filter(3, 0.6, seed=2), 16),
             (17, make_box_filter(3, 0.9, seed=3), 9),
             (5, ball, 20), (64, ball, 32), (7, None, 10),
             (2, IntervalFilter(dim=2, lo=0.4), 100)]
    groups = [(torch.randn((b, d), generator=gen, device=card), f, k)
              for b, f, k in specs]
    before = b1.grouped_launch_stats()
    got = ops.sharded_filtered_topk_grouped(groups, xs, ss, m=3)
    after = b1.grouped_launch_stats()
    assert after["launches"] - before["launches"] == 2     # box, ball
    assert after["groups"] - before["groups"] == 5
    torch.cuda.synchronize()
    for (q, f, k), (gi, gd) in zip(groups, got):
        si, sd = ops.sharded_filtered_topk(q, xs, ss, f, k, m=3)
        assert torch.equal(gi, si) and torch.equal(gd, sd)
    solo = launch_config(S, 200, n, d, 16, 0, 0, 132)["splits"]
    grouped = launch_config(3 * S, 200, n, d, 16, 0, 0, 132)["splits"]
    assert (solo != grouped) == (n == 20000)


def test_grouped_filtered_topk_copies_no_block(card):
    """Eight groups over a 154 MB shard stack: the launch allocates its
    outputs and split scratch only — never a copy of the block."""
    S, n, d = 2, 200_000, 96
    x, s = make_dataset_device(S * n, d, 3, seed=3, device=card)
    xs, ss = x.reshape(S, n, d), s.reshape(S, n, 3)
    block = xs.numel() * 4
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    groups = [(torch.randn((16, d), generator=gen, device=card),
               make_box_filter(3, 0.2 + 0.1 * i, seed=i), 10)
              for i in range(8)]
    ops.sharded_filtered_topk_grouped(groups, xs, ss, m=3)   # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ops.sharded_filtered_topk_grouped(groups, xs, ss, m=3)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert len(out) == 8 and extra < block // 4, (extra, block)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_chaos_tape_on_card(card, quantize, tmp_path):
    """A short lifecycle tape under seeded crashes on a persistent,
    budgeted manager on the card: every injected crash recovered, every
    answer (deadline queries included) the fault-free oracle's bit for
    bit, every fault point hit."""
    from repro_torch.core import CubeGraphConfig
    from repro_torch.streaming import (FAULT_POINTS, FaultInjector,
                                       SegmentManager, StreamConfig)
    from repro_torch.streaming.chaos import (CRASH_POINTS, apply_op,
                                             lifecycle_ops, run_chaos)
    d = 64
    ops_ = lifecycle_ops(2, 4000, d)
    base = dict(time_dim=2, seal_max_points=1 << 30, n_shards=2,
                compact_max_segments=3, quantize=quantize, graph_ef=128,
                wal_fsync_every=4,
                index_cfg=CubeGraphConfig(n_layers=2, m_intra=8, m_cross=3))
    oracle = SegmentManager(d, 3, StreamConfig(**base), device=card)
    want = [apply_op(oracle, op) for op in ops_]
    root = str(tmp_path / "p")
    cfg = StreamConfig(**base, persist_dir=root,
                       device_budget_bytes=oracle._pack.nbytes // 3)
    inj = FaultInjector(seed=11, rate=0.18, max_faults=5,
                        points=CRASH_POINTS)

    def restore():
        m = SegmentManager.restore(root, cfg=cfg, device=card)
        m.install_fault_injector(inj)
        return m

    m = SegmentManager(d, 3, cfg, device=card)
    m.install_fault_injector(inj)
    rec = run_chaos(m, ops_, want, inj, restore, deadline_ms=60_000.0)
    assert rec["faults"] >= 1 and rec["queries"] > 0
    assert not [p for p in FAULT_POINTS if not inj.hits.get(p)], inj.hits


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_deadline_path_equals_bulk_on_card(card, quantize):
    """A query with a deadline it meets dispatches bucket by bucket (and
    reranks an int8 pack per bucket); its answer is the bulk dispatch's
    bit for bit — the int8 rerank scores with B4, whose order depends on
    d alone, not on the candidate list's width."""
    from repro_torch.core import CubeGraphConfig
    from repro_torch.streaming import SegmentManager, StreamConfig
    rng = np.random.default_rng(4)
    cfg = StreamConfig(time_dim=2, seal_max_points=1 << 30, n_shards=2,
                       quantize=quantize,
                       index_cfg=CubeGraphConfig(n_layers=2, m_intra=8,
                                                 m_cross=3))
    m = SegmentManager(96, 3, cfg, device=card)
    for i, n in enumerate((300, 700, 1500, 3100)):
        x = rng.normal(size=(n, 96)).astype(np.float32)
        s = rng.uniform(size=(n, 3))
        s[:, 2] = i + np.linspace(0.0, 0.9, n)
        m.ingest(x, s)
        m.seal()
    q = rng.normal(size=(64, 96)).astype(np.float32)
    for f in (None, IntervalFilter(dim=2, lo=0.5, hi=2.5)):
        g0, d0 = m.query(q, f, k=10)
        r = m.query(q, f, k=10, deadline_ms=60_000.0)
        assert not r.degraded
        assert np.array_equal(g0, r[0]) and np.array_equal(d0, r[1])


# ---------------------------------------------------------------------------
# the training path on the card
# ---------------------------------------------------------------------------
TRAIN_FAMILIES = ("codeqwen1.5-7b", "gemma3-1b", "qwen2-moe-a2.7b",
                  "internvl2-2b", "falcon-mamba-7b", "zamba2-2.7b",
                  "whisper-medium")


def _to(tree, dev):
    """A copy of ``tree`` on ``dev`` (train steps update in place)."""
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev, copy=True)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_step_on_card_matches_cpu(card, arch):
    """The loss and gradients of each family's fp32 smoke model (remat
    on) on the card against the same on CPU tensors: the loss within 1e-5
    relative, each gradient leaf within 1e-4 x its largest magnitude (the
    CPU parity tests' tolerances); then one train step on each device
    reports that loss (within 1e-6: the MoE's ``index_add_`` adds with
    atomics on the card) and leaves finite parameters."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 loss_and_grads,
                                                 make_train_step)
    from repro_torch.training.tree import leaves
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              remat=True)
    model = build_model(cfg)
    cpu_p = init_params(model.param_specs(), seed=0, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(4, 32)),
             "labels": rng.integers(-1, cfg.vocab, size=(4, 32))}
    if cfg.n_enc_layers:
        batch["frames"] = rng.normal(size=(4, cfg.n_frames, cfg.d_model)
                                     ).astype(np.float32)
    if cfg.n_patches:
        batch["patches"] = rng.normal(size=(4, cfg.n_patches, cfg.d_model)
                                      ).astype(np.float32)
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("cuda", card)):
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        p = _to(cpu_p, dev)
        loss, grads = loss_and_grads(model, p, b)
        oc = OptConfig(lr=1e-3, warmup_steps=0, schedule="const")
        state, m = make_train_step(model, oc)(init_train_state(p), b)
        assert float(m["loss"]) == pytest.approx(float(loss), rel=1e-6)
        assert all(bool(torch.isfinite(q).all())
                   for q in leaves(state["params"]))
        out[name] = (loss.cpu(), [g.cpu() for g in leaves(grads)])
    (l0, g0), (l1, g1) = out["cpu"], out["cuda"]
    assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


def test_adamw_fp32_update_on_card_matches_cpu(card):
    """Three AdamW steps (clip on) of an fp32 tree on the card against the
    CPU: parameters, moments, the learning rate and the gradient norm
    within fp32 rounding (1e-6 relative)."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.tree import leaves
    gen = torch.Generator().manual_seed(11)

    def tree():
        return {"a": torch.randn(300, 70, generator=gen),
                "b": {"c": torch.randn(4097, generator=gen) * 3}}

    params = {"cpu": tree()}
    params["cuda"] = _to(params["cpu"], card)
    states = {k: opt.init_opt_state(v) for k, v in params.items()}
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    for _ in range(3):
        g = tree()
        got = {}
        for k, dev in (("cpu", "cpu"), ("cuda", card)):
            _, states[k], got[k] = opt.adamw_update(params[k], _to(g, dev),
                                                    states[k], cfg)
        for key in ("lr", "grad_norm"):
            assert float(got["cuda"][key]) == pytest.approx(
                float(got["cpu"][key]), rel=1e-6)
    for a, b in zip(leaves(params["cpu"]) + leaves(states["cpu"]),
                    leaves(params["cuda"]) + leaves(states["cuda"])):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-8)


def test_checkpoint_restores_onto_the_card(card, tmp_path):
    """A CPU-written state (bf16 and fp32 leaves) restored onto a card
    template lands there bit for bit."""
    from repro_torch.training.checkpoint import CheckpointManager
    gen = torch.Generator().manual_seed(12)
    st = {"w": torch.randn(64, 32, generator=gen).bfloat16(),
          "m": torch.randn(64, 32, generator=gen),
          "step": torch.tensor(9, dtype=torch.int32)}
    cm = CheckpointManager(str(tmp_path))
    cm.save(9, st)
    restored, _ = cm.restore(_to(st, card))
    for k, v in st.items():
        assert restored[k].device == card and restored[k].dtype == v.dtype
        assert torch.equal(restored[k].cpu(), v)


COMPRESS_SCRIPT = r"""
import sys
import torch
import torch.distributed as dist
from repro_torch.training.compression import (compress_residual,
                                              compressed_psum,
                                              init_error_state)
store = sys.argv[1]
dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                        world_size=1, device_id=torch.device("cuda:0"))
try:
    gloo = dist.new_group(backend="gloo")
    gen = torch.Generator().manual_seed(7)
    grads = {"w": torch.randn(257, 129, generator=gen) * 3.0,
             "b": (torch.randn(1000, generator=gen) * 1e-3
                   ).to(torch.bfloat16),
             "z": torch.zeros(17)}
    grads["w"][0, :4] = torch.tensor([127.0, 63.5, -0.5, 2.5])
    card = {k: v.cuda() for k, v in grads.items()}

    def bits(t):
        t = t.cpu()
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for k in grads:
        for a, b in zip(compress_residual(card[k].float()),
                        compress_residual(grads[k].float())):
            assert torch.equal(bits(a), bits(b)), k
    e_card, e_cpu = init_error_state(card), init_error_state(grads)
    for _ in range(3):
        a_card, e_card = compressed_psum(card, e_card)
        a_cpu, e_cpu = compressed_psum(grads, e_cpu, group=gloo)
        for k in grads:
            assert torch.equal(bits(a_card[k]), bits(a_cpu[k])), k
            assert torch.equal(bits(e_card[k]), bits(e_cpu[k])), k
    dist.destroy_process_group(gloo)
finally:
    dist.destroy_process_group()
print("COMPRESS OK")
"""


def test_compressed_psum_on_card_matches_cpu(card, tmp_path):
    """int8 compression with error feedback over a one-rank NCCL group on
    the card: q, scale and residual of each leaf (fp32, bf16, all-zero,
    exact halves) and three steps' means and errors bit for bit those of
    the same function on the CPU over a gloo group.  The process group
    lives in a subprocess, so this test worker keeps none."""
    import os
    import subprocess
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run([sys.executable, "-c", COMPRESS_SCRIPT,
                        str(tmp_path / "store")], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "COMPRESS OK" in r.stdout

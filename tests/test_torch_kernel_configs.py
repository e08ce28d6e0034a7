"""Launch configurations of kernels B1–B5, the tile-skip counts, and the
premise of the tile skip, checked on the CPU.

- Every configuration the wrappers (``kernels/filtered_topk.py``,
  ``kernels/distance.py``, ``kernels/quant_topk.py``,
  ``kernels/graph_topk.py`` and ``kernels/flash_decode.py``, each
  ``launch_config``) can pick fits one
  H100 block (232,448 bytes of dynamic shared memory), the blocks per SM
  it counts on fit the SM's 233,472 bytes with 1,024 reserved per block,
  and each copy width divides both the base pointer and the row stride.
  B1's and B3's splits cover their candidates with at most ``MAX_TILES``
  tiles of 128 each, and B5's grid is what one card holds at once.  No
  configuration depends on the metadata width (m <= 16, mp >= m): the
  kernels read the packed filter parameters from global memory.  The
  expected layouts of ``csrc/topk_pass1.cuh`` (B1, B3),
  ``csrc/graph_step.cu`` (B4) and ``csrc/flash_decode.cu`` (B5) are
  written out here a second time, from
  the C sources' constants; the C launchers refuse any other size at run
  time.
- ``live_tiles`` (passing candidates, tiles with one, tiles) equals a
  brute-force count from the filter object.
- The skip's premise in both packages: the answer of the scans (B1 fp32,
  B3 int8) does not depend on the vectors or codes of candidates that
  fail the predicate.  The reference's ``filtered_topk`` and
  ``sharded_quant_filtered_topk`` (Pallas in interpret mode, as
  ``tests/test_kernels.py`` and ``tests/test_quant.py`` run them) and the
  port's twins ``filtered_topk_plain`` and ``quant_topk_plain`` give the
  same answer, bit for bit, when those are replaced by random values; the
  two packages agree within the parity tolerance of
  ``tests/test_torch_kernels.py``.
"""
import importlib
import itertools

import numpy as np
import pytest
import torch

from repro.core import BoxFilter as JBox
from repro.core import ComposeFilter as JCompose
from repro.core import IntervalFilter as JInterval
from repro.kernels import PAD_META, quant_meta_rows
from repro.kernels.ops import filtered_topk as ref_filtered_topk
from repro.kernels.ops import sharded_quant_filtered_topk
from repro.quant import encode_segment
from repro_torch.core import (BallFilter, BoxFilter, ComposeFilter,
                              IntervalFilter)
from repro_torch.kernels import distance as tdist
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_topk as tqt
from repro_torch.kernels.ref import filter_mask_ref

# the package re-exports functions under these modules' names
tft = importlib.import_module("repro_torch.kernels.filtered_topk")
tfd = importlib.import_module("repro_torch.kernels.flash_decode")
tg = importlib.import_module("repro_torch.kernels.graph_topk")
torch.set_num_threads(1)

MAX_SMEM = 232_448        # dynamic shared memory one block may ask for
SM_BYTES = 233_472        # shared memory of one SM
RESERVED = 1024           # per resident block


def _check_width(vec, ptr, row_bytes):
    assert vec in (0, 4, 16)
    if vec:
        assert ptr % vec == 0 and row_bytes % vec == 0
    if ptr % 16 == 0 and row_bytes % 16 == 0:
        assert vec == 16                    # the widest copy it may take


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_distance_launch_configs_fit(dtype):
    size = 4 if dtype == torch.float32 else 2
    for bq, d, qoff, xoff in itertools.product(
            (1, 37, 64, 65, 1000), (1, 3, 8, 96, 130, 768),
            range(0, 16, size), (0, size, 8, 12)):
        qp, xp = 1 << 20 | qoff, 1 << 21 | xoff
        cfg = tdist.launch_config(bq, 131_072, d, dtype, qp, xp)
        assert cfg["threads"] == 256
        assert cfg["tq"] == (128 if bq > 64 else 64)
        assert cfg["smem"] <= MAX_SMEM
        assert cfg["min_blocks"] * (cfg["smem"] + RESERVED) <= SM_BYTES
        _check_width(cfg["vec_q"], qp, d * size)
        _check_width(cfg["vec_x"], xp, d * size)


def _pass1_tail(tq, kpad):
    """The part of csrc/topk_pass1.cuh's layout (p1::Cfg) past the ring,
    the distance tile and the norms: 64 tiles of ok bits (256 words) with
    their 16-bit prefix counts, two 16-bit row lists of a packed tile of
    128, the passing count (16 bytes) and the lists."""
    return 256 * 4 + 256 * 2 + 2 * 128 * 2 + 16 + tq * kpad * 8


def _quant_smem(tq, kpad):
    """csrc/topk_pass1.cuh's layout for int8 codes (p1::Cfg with int8_t),
    from its constants: BK 16, fp32 ring rows of 20 floats, int8 ring
    rows of 16 bytes, 3 stages, k-major copies [16][rows + 4] twice, TN
    128, the [tq][128] distance tile, a norm row of 128, then the tail."""
    ring = 3 * (tq * 20 * 4 + 128 * 16) \
        + 2 * (16 * (tq + 4) * 4 + 16 * 132 * 4)
    return ring + tq * 128 * 4 + 128 * 4 + _pass1_tail(tq, kpad)


@pytest.mark.parametrize("kpad", [2 ** i for i in range(12)])
def test_quant_topk_launch_configs_fit(kpad):
    for g, bq, n, d, qoff, coff in itertools.product(
            (1, 3, 16), (1, 29, 1000), (1, 127, 128, 1200, 8192, 100_003),
            (3, 96, 130, 768), (0, 4, 8), (0, 1, 4, 8)):
        qp, cp = 1 << 20 | qoff, 1 << 21 | coff
        cfg = tqt.launch_config(g, bq, n, d, kpad, qp, cp, 132)
        tq = cfg["tq"]
        assert cfg["threads"] == 256 and tq in (8, 16, 32, 64)
        assert cfg["smem"] == _quant_smem(tq, kpad) <= MAX_SMEM
        assert cfg["min_blocks"] * (cfg["smem"] + RESERVED) <= SM_BYTES
        # two blocks per SM wherever a tile allows it
        assert cfg["min_blocks"] == 2 or all(
            2 * (_quant_smem(t, kpad) + RESERVED) > SM_BYTES
            for t in (8, 16, 32, 64))
        splits = cfg["splits"]
        assert 1 <= splits <= 65_535
        assert splits * tqt.MAX_TILES * tqt.TN >= n
        _check_width(cfg["vec_q"], qp, d * 4)
        _check_width(cfg["vec_c"], cp, d)


def _b1_smem(tq, kpad):
    """csrc/topk_pass1.cuh's layout for fp32 candidates (p1::Cfg with
    float), from its constants: BK 16, fp32 ring rows of 20 floats for
    both operands, 3 stages, k-major copies [16][rows + 4] twice, TN 128,
    the [tq][128] distance tile, a norm row of 128, tq query norms, then
    the tail."""
    ring = 3 * (tq * 20 * 4 + 128 * 20 * 4) \
        + 2 * (16 * (tq + 4) * 4 + 16 * 132 * 4)
    return ring + tq * 128 * 4 + 128 * 4 + tq * 4 + _pass1_tail(tq, kpad)


@pytest.mark.parametrize("kpad", [2 ** i for i in range(11)])
def test_filtered_topk_launch_configs_fit(kpad):
    for g, bq, n, d, qoff, xoff in itertools.product(
            (1, 3, 16), (1, 29, 1000), (1, 127, 128, 1200, 8192, 1_000_000),
            (3, 96, 130, 768), (0, 4, 8), (0, 4, 8)):
        qp, xp = 1 << 20 | qoff, 1 << 21 | xoff
        cfg = tft.launch_config(g, bq, n, d, kpad, qp, xp, 132)
        tq = cfg["tq"]
        assert cfg["threads"] == 256 and tq in (8, 16, 32, 64)
        assert cfg["smem"] == _b1_smem(tq, kpad) <= MAX_SMEM
        assert cfg["min_blocks"] * (cfg["smem"] + RESERVED) <= SM_BYTES
        # two blocks per SM wherever a tile allows it
        assert cfg["min_blocks"] == 2 or all(
            2 * (_b1_smem(t, kpad) + RESERVED) > SM_BYTES
            for t in (8, 16, 32, 64))
        splits = cfg["splits"]
        assert 1 <= splits <= 65_535
        assert splits * tft._pass1.MAX_TILES * tft._pass1.TN >= n
        _check_width(cfg["vec_q"], qp, d * 4)
        _check_width(cfg["vec_x"], xp, d * 4)


def test_filtered_topk_scan_config():
    """The 1M-vector scan (k = 10) runs 64-row tiles two to an SM, in
    splits of at most 64 candidate tiles over about four waves; wider lists
    fall back to fewer rows."""
    cfg = tft.launch_config(1, 1000, 1_000_000, 768, 16, 1 << 20, 1 << 21,
                            132)
    assert (cfg["tq"], cfg["min_blocks"]) == (64, 2)
    assert cfg["splits"] * 64 * 128 >= 1_000_000
    assert 16 * cfg["splits"] >= 4 * 2 * 132
    assert tft.launch_config(1, 1000, 1_000_000, 768, 32, 1 << 20, 1 << 21,
                             132)["tq"] < 64


def _b5_smem(bkv, hd, size, gc):
    """csrc/flash_decode.cu's layout (Geo), from its constants: tiles of
    64 keys (32 where a key row is longer than 256 bytes), 3 stages (2 for
    fp32 at hd 256) of K (rows padded by 16 bytes), V and the query row
    (gc heads), the probabilities [gc][tile] and query rows [gc][hd + 4]
    in fp32, 4 warps' maximum and sum per head, the ticket (16 bytes)
    and the tile prefix sums (bkv + 1 int32, rounded up to 16 bytes)."""
    ts = 64 if hd * size <= 256 else 32
    stages = 2 if (size, hd) == (4, 256) else 3
    stage = ts * (hd * size + 16) + ts * hd * size + gc * hd * size
    return (stages * stage + gc * ts * 4 + gc * (hd + 4) * 4
            + 2 * 4 * gc * 4 + 16 + (bkv + 1 + 3) // 4 * 16)


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_launch_configs_fit(dtype, hd):
    size = 4 if dtype == torch.float32 else 2
    for bkv, g, smax in itertools.product((1, 5, 64, 600, 4096),
                                          range(1, 17),
                                          (1, 50, 1037, 4096, 32_768)):
        cfg = tfd.launch_config(bkv, g, smax, hd, dtype, 132)
        gc = cfg["gc"]
        assert cfg["threads"] == 128
        assert gc in (1, 2, 4, 8, 16) and g <= gc < 2 * g
        assert cfg["smem"] == _b5_smem(bkv, hd, size, gc) <= MAX_SMEM
        assert cfg["min_blocks"] * (cfg["smem"] + RESERVED) <= SM_BYTES
        # the grid is what the card holds at once (its scratch: two
        # partial results a block, whatever smax and the rows)
        assert cfg["blocks"] == cfg["min_blocks"] * 132
        # 16-byte copies: rows are whole pieces, and the wrapper refuses
        # base pointers off 16-byte alignment
        assert cfg["vec"] == 16 and hd * size % 16 == 0


def _b4_smem(dp, rows_staged):
    """csrc/graph_step.cu's layout, from its constants: staged scales
    [rows_staged, dp] and the query row [dp] in fp32, its norm (16 bytes),
    the live list of a chunk of 1024 lanes (two ints each), the position
    sort's 256 bins and 48 ints of warp sums, starts and total, and two
    metadata rows of 16 floats for each of the 32 groups of 8 lanes of a
    256-thread block."""
    return (rows_staged + 1) * dp * 4 + 16 + 1024 * 8 + 1216 + 32 * 128


@pytest.mark.parametrize("quantized", [False, True])
def test_graph_step_launch_configs_fit(quantized):
    """B4: one block per query, whatever c (a block compacts its lanes
    1024 at a time); a row is cut into 16-byte pieces (4 fp32 or 16 int8
    values); int8 scales are staged up to 64 KB and read from global
    memory above that."""
    w = 16 if quantized else 4
    for b, d, rows, xoff in itertools.product(
            (1, 7, 1000), (3, 96, 130, 768, 4096), (1, 16, 24, 200),
            (0, 4, 16)):
        xp, sp = 1 << 22 | xoff, 1 << 21
        cfg = tg.launch_config(b, d, rows, quantized, xp, sp)
        dp = -(-d // w) * w
        assert cfg["threads"] == 256 and cfg["blocks"] == b
        staged = quantized and rows * dp * 4 <= 64 * 1024
        assert cfg["stage"] == int(staged)
        assert cfg["smem"] == _b4_smem(dp, rows if staged else 0) <= MAX_SMEM
        assert cfg["vec"] == int(d % w == 0 and xoff % 16 == 0)
    # phase 5b's forced-graph hop: d = 768 over a [16, 8192] bucket, three
    # blocks to an SM with the int8 scales staged
    f32 = tg.launch_config(1000, 768, 16, False, 1 << 22, 1 << 21)
    i8 = tg.launch_config(1000, 768, 16, True, 1 << 22, 1 << 21)
    assert (f32["stage"], f32["vec"], i8["stage"], i8["vec"]) == (0, 1, 1, 1)
    assert 3 * (i8["smem"] + RESERVED) <= SM_BYTES


_LIVE_FILTERS = {
    "none": None,
    "box": BoxFilter(lo=np.asarray([0.2, 0.1, 0.0], np.float32),
                     hi=np.asarray([0.7, 0.9, 1.0], np.float32)),
    "interval": IntervalFilter(dim=2, lo=0.55, hi=0.8),
    "ball": BallFilter(center=np.asarray([0.5, 0.5]), radius=0.2),
    "box_and_interval": ComposeFilter(
        BoxFilter(lo=np.asarray([0.2, 0.2, 0.0], np.float32),
                  hi=np.asarray([0.8, 0.8, 1.0], np.float32)),
        IntervalFilter(dim=2, lo=0.6, hi=1.0), "and"),
}


def _time_ordered_stack(g, n, m, seed, dead_rows=(1,)):
    """[g, n, m] metadata: uniform places, a time column rising along each
    row, ``PAD_META`` on whole dead rows and on a ragged tail."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(size=(g, n, m)).astype(np.float32)
    s[:, :, 2] = np.arange(n, dtype=np.float32) / n
    for r in dead_rows:
        s[r] = PAD_META
    s[-1, n - 37:] = PAD_META
    return s


@pytest.mark.parametrize("name", list(_LIVE_FILTERS))
def test_live_tiles_match_brute_force(name):
    g, n, m, tile = 4, 1000, 3, 128
    s = _time_ordered_stack(g, n, m, seed=len(name))
    filt = _LIVE_FILTERS[name]
    kind, params = tops.encode_filter(filt, m, mpad=m)
    st = torch.as_tensor(s)
    passing, live, tiles = tqt.live_tiles(st, torch.as_tensor(params), kind,
                                          tile)
    ok = np.ones((g, n), bool) if filt is None \
        else filt.contains(st).numpy()
    ok &= s[..., 0] < 1e30                  # PAD_META fails every kind
    per_row = -(-n // tile)
    want_live = sum(bool(ok[r, t * tile:(t + 1) * tile].any())
                    for r in range(g) for t in range(per_row))
    assert passing == int(ok.sum())
    assert (live, tiles) == (want_live, g * per_row)
    assert 0 < live < tiles                 # the stack has dead tiles


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("name", list(_LIVE_FILTERS))
def test_packed_tiles_match_brute_force(name, splits):
    """What the kernels multiply: each split packs its passing candidates
    (tiles s, s + splits, ... of 128 of a row) into tiles of 128."""
    g, n, m, tile = 4, 1000, 3, 128
    s = _time_ordered_stack(g, n, m, seed=len(name))
    filt = _LIVE_FILTERS[name]
    kind, params = tops.encode_filter(filt, m, mpad=m)
    got = tft._pass1.packed_tiles(torch.as_tensor(s),
                                  torch.as_tensor(params), kind, splits)
    ok = np.ones((g, n), bool) if filt is None \
        else filt.contains(torch.as_tensor(s)).numpy()
    ok &= s[..., 0] < 1e30                  # PAD_META fails every kind
    want = 0
    for r in range(g):
        for sp in range(splits):
            cands = [c for t in range(sp, -(-n // tile), splits)
                     for c in range(t * tile, min(n, (t + 1) * tile))]
            want += -(-int(ok[r, cands].sum()) // tile)
    assert got == want


@pytest.mark.parametrize("fname", ["interval", "box_and_interval"])
def test_tile_skip_premise_in_both_packages(fname):
    g, cap, n, d, m, k = 3, 384, 350, 32, 3, 16
    s = _time_ordered_stack(g, cap, m, seed=7, dead_rows=(1,))
    s[:, n:] = PAD_META                     # the rows' free slots
    rng = np.random.default_rng(11)
    x = rng.normal(size=(g, cap, d)).astype(np.float32)
    q = rng.normal(size=(5, d)).astype(np.float32)
    tfilt = _LIVE_FILTERS[fname]
    jfilt = (JInterval(dim=2, lo=0.55, hi=0.8) if fname == "interval" else
             JCompose(JBox(lo=np.asarray([0.2, 0.2, 0.0], np.float32),
                           hi=np.asarray([0.8, 0.8, 1.0], np.float32)),
                      JInterval(dim=2, lo=0.6, hi=1.0), "and"))
    kind, params = tops.encode_filter(tfilt, m, mpad=m)
    fail = ~filter_mask_ref(torch.as_tensor(s), kind,
                            torch.as_tensor(params)).numpy()
    assert fail.any() and not fail.all()
    codes = np.zeros((g, cap, d), np.int8)
    xsq = np.zeros((g, cap), np.float32)
    scales = np.zeros((g, d), np.float32)
    for gi in range(g):
        sq = encode_segment(x[gi, :n])
        codes[gi, :n], xsq[gi, :n], scales[gi] = sq.codes, sq.xsq, sq.scales
    noise = np.random.default_rng(13).integers(-128, 128, size=codes.shape,
                                                dtype=np.int8)
    dirty = np.where(fail[..., None], noise, codes)

    # the reference: transposed [g, dq, cap] codes, metadata rows + xsq
    dq, mq = max(32, -(-d // 32) * 32), quant_meta_rows(m)
    stt = np.zeros((g, mq, cap), np.float32)
    stt[:, :m] = s.transpose(0, 2, 1)
    stt[:, mq - 1] = xsq
    sc = np.zeros((g, dq), np.float32)
    sc[:, :d] = scales
    answers = []
    for cd in (codes, dirty):
        ct = np.zeros((g, dq, cap), np.int8)
        ct[:, :d] = cd.transpose(0, 2, 1)
        ids, dd = sharded_quant_filtered_topk(q, ct, stt, sc, jfilt, k, m=m)
        answers.append((np.asarray(ids), np.asarray(dd)))
    assert np.isfinite(answers[0][1]).any()
    for a, b in zip(*answers):
        assert np.array_equal(a, b)

    # the port's twin: row-major codes, folded queries
    qs = torch.as_tensor(q)[None] * torch.as_tensor(scales)[:, None, :]
    p = torch.as_tensor(params)
    got = [tqt.quant_topk_plain(qs, torch.as_tensor(cd), torch.as_tensor(s),
                                torch.as_tensor(xsq), p, kind, k)
           for cd in (codes, dirty)]
    assert torch.isfinite(got[0][0]).any()
    for a, b in zip(*got):
        assert torch.equal(a, b)


def _parity(ids_t, d_t, ids_j, d_j, tol):
    """Port lists vs reference lists [bq, k]: the same misses, distances
    within ``tol`` ([bq, 1]), ids equal where the reference's distance is
    separated from its list neighbours by more than twice that."""
    ids_t, d_t = np.asarray(ids_t), np.asarray(d_t, np.float64)
    ids_j, d_j = np.asarray(ids_j), np.asarray(d_j, np.float64)
    fin = np.isfinite(d_j)
    assert np.array_equal(np.isfinite(d_t), fin)
    assert np.array_equal(ids_t < 0, ~fin) and np.array_equal(ids_j < 0, ~fin)
    assert np.all(np.abs(np.where(fin, d_t - d_j, 0.0)) <= tol)
    dj = np.where(fin, d_j, 1e300)
    gap = np.diff(dj, axis=1)
    big = np.full((dj.shape[0], 1), np.inf)
    unique = fin & (np.concatenate([big, gap], 1) > 2 * tol) \
        & (np.concatenate([gap, big], 1) > 2 * tol)
    unique[:, -1] = False
    assert np.array_equal(ids_t[unique], ids_j[unique])


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("fname", ["interval", "box_and_interval"])
def test_filtered_topk_skip_premise_in_both_packages(fname, metric):
    """B1's skip: a time-ordered set with a ``PAD_META`` tail, whose
    first part fails the interval; the vectors of every failing candidate
    are replaced by large random values."""
    n, d, m, k = 600, 32, 3, 10
    s = _time_ordered_stack(1, n, m, seed=5, dead_rows=())[0]
    s[n - 70:] = PAD_META
    rng = np.random.default_rng(17)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = x[rng.integers(0, n, 5)] + 0.05 * rng.normal(size=(5, d)) \
        .astype(np.float32)
    tfilt = _LIVE_FILTERS[fname]
    jfilt = (JInterval(dim=2, lo=0.55, hi=0.8) if fname == "interval" else
             JCompose(JBox(lo=np.asarray([0.2, 0.2, 0.0], np.float32),
                           hi=np.asarray([0.8, 0.8, 1.0], np.float32)),
                      JInterval(dim=2, lo=0.6, hi=1.0), "and"))
    kind, params = tops.encode_filter(tfilt, m, mpad=m)
    fail = ~filter_mask_ref(torch.as_tensor(s[None]), kind,
                            torch.as_tensor(params)).numpy()[0]
    assert fail.any() and not fail.all()
    noise = 100 * np.random.default_rng(19).normal(size=x.shape) \
        .astype(np.float32)
    dirty = np.where(fail[:, None], noise, x)

    # the reference: its Pallas kernel in interpret mode (k = 10)
    ref = [tuple(np.asarray(a) for a in
                 ref_filtered_topk(q, xx, s, jfilt, k, metric=metric))
           for xx in (x, dirty)]
    assert np.isfinite(ref[0][1]).any()
    for a, b in zip(*ref):
        assert np.array_equal(a, b)

    # the port's twin
    p = torch.as_tensor(params)[None]
    got = [tft.filtered_topk_plain(torch.as_tensor(q)[None],
                                   torch.as_tensor(xx)[None],
                                   torch.as_tensor(s)[None], p, kind, 16,
                                   metric)
           for xx in (x, dirty)]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    tol = 1e-5 * ((q.astype(np.float64) ** 2).sum(1)
                  + (x.astype(np.float64) ** 2).sum(1).max())[:, None]
    _parity(got[0][1][0, :, :k], got[0][0][0, :, :k], ref[0][0], ref[0][1],
            tol)

"""Launch configurations of kernels B2 and B3, B3's tile-skip counts, and
the premise of the tile skip, checked on the CPU.

- Every configuration the wrappers (``kernels/distance.py::launch_config``,
  ``kernels/quant_topk.py::launch_config``) can pick fits one H100 block
  (232,448 bytes of dynamic shared memory, 256 threads), the blocks per SM
  it counts on fit the SM's 233,472 bytes, and each copy width divides
  both the base pointer and the row stride.  No configuration depends on
  the metadata width (m <= 16, mp >= m): the kernel reads the packed
  filter parameters from global memory.  The expected layout of
  ``csrc/quant_topk.cu`` is written out here a second time, from the C
  source's constants; the C launcher refuses any other size at run time.
- ``quant_topk.live_tiles`` (passing candidates, tiles with one, tiles)
  equals a brute-force count from the filter object.
- The skip's premise in both packages: the answer of the int8 scan does
  not depend on the codes of candidates that fail the predicate.  The
  reference's ``sharded_quant_filtered_topk`` (Pallas in interpret mode,
  as ``tests/test_quant.py`` runs it) and the port's twin
  ``quant_topk_plain`` give the same answer, bit for bit, when those codes
  are replaced by random bytes.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.core import BoxFilter as JBox
from repro.core import ComposeFilter as JCompose
from repro.core import IntervalFilter as JInterval
from repro.kernels import PAD_META, quant_meta_rows
from repro.kernels.ops import sharded_quant_filtered_topk
from repro.quant import encode_segment
from repro_torch.core import (BallFilter, BoxFilter, ComposeFilter,
                              IntervalFilter)
from repro_torch.kernels import distance as tdist
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_topk as tqt
from repro_torch.kernels.ref import filter_mask_ref

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


def _quant_smem(tq, kpad):
    """csrc/quant_topk.cu's layout (QCfg, sg::Ring), from its constants:
    BK 16, fp32 ring rows of 20 floats, int8 ring rows of 16 bytes, 3
    stages, k-major copies [16][rows + 4] twice, TN 128, 64 tiles."""
    ring = 3 * (tq * 20 * 4 + 128 * 16) \
        + 2 * (16 * (tq + 4) * 4 + 16 * 132 * 4)
    return (ring + tq * 128 * 4 + 2 * 128 * 4 + 64 * 4 * 4 + 65 * 4
            + tq * kpad * 8)


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

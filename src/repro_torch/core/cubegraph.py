"""CubeGraph index — public API (paper §4: construction, query, updates).

``CubeGraphIndex.build`` runs Alg. 1 + Alg. 2 over L grid layers;
``query`` plans (layer selection per Prop. 1 + cube identification §4.3) on
the host and executes the batched stitched-graph beam search on the
index's device; ``insert_batch`` / ``delete`` implement §4.4 dynamic
updates (incremental insertion + lazy deletion with validity mask).

Vectors, norms, fp32 metadata and edges live on the device; cube tables,
the host copy of the metadata used for planning and the validity mask
live on the host.  The on-disk format (``save_index`` / ``load_index``) is plain
npy/npz/json, the same files the JAX package reads and writes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .filters import BoxFilter, Filter
from .graph import (CubeMap, LayerGraph, _cube_map, _face_adjacent_flat,
                    build_layer_graph, occlusion_prune, squared_norms,
                    topk_over_candidates)
from .grid import GridSpec
from .search import SearchParams, beam_search

__all__ = ["CubeGraphConfig", "CubeGraphIndex", "QueryStats", "load_index",
           "load_index_extras", "save_index"]


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class CubeGraphConfig:
    n_layers: int = 4
    m_intra: int = 16              # max intra-cube degree  (paper: M)
    m_cross: int = 4               # cross-cube degree       (paper: M_cross)
    metric: str = "l2"
    min_cube_size: int = 50        # hierarchy termination (paper Exp-4)
    point_chunk: int = 2048
    col_chunk: int = 2048


@dataclasses.dataclass
class QueryStats:
    layer: int
    n_active_cubes: int
    elastic_capacity: int
    mode: str
    plan_ms: float = 0.0
    search_ms: float = 0.0
    hops: int = 0                  # beam-search iterations this batch ran


class CubeGraphIndex:
    """Hierarchical-grid stitched-graph index (the paper's contribution)."""

    def __init__(self, cfg: CubeGraphConfig, grid: GridSpec,
                 layers: List[LayerGraph], x, s, norms, valid):
        self.cfg = cfg
        self.grid = grid
        self.layers = layers
        self.x = x                       # torch [n, d] fp32 (device)
        self.s = s                       # torch [n, m] fp32 (device)
        self.s_np = s.cpu().numpy()      # fp32 host copy for planning
        self.norms = norms               # torch [n]
        self.valid = valid               # np bool [n]
        self.build_seconds: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.x.device

    # ------------------------------------------------------------------
    # Construction (Alg. 1 + Alg. 2)
    # ------------------------------------------------------------------
    @staticmethod
    def build(x, s, cfg: CubeGraphConfig = CubeGraphConfig(),
              device=None) -> "CubeGraphIndex":
        t0 = time.perf_counter()
        dev = resolve_device(device, x)
        x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
        s_np = np.asarray(s, np.float64)
        n, m = s_np.shape
        # int32 cube ids must not overflow: g^m < 2^31.
        max_layers = cfg.n_layers
        while (2 ** (max_layers)) ** m >= 2 ** 31:
            max_layers -= 1
        grid = GridSpec.fit(s_np, n_layers=max_layers)
        norms = squared_norms(x)
        layers: List[LayerGraph] = []
        for level in range(grid.n_layers):
            layer = grid.layer(level)
            lg = build_layer_graph(
                x, s_np, norms, layer, m_intra=cfg.m_intra, m_cross=cfg.m_cross,
                point_chunk=cfg.point_chunk, col_chunk=cfg.col_chunk,
                metric=cfg.metric)
            layers.append(lg)
            # Hierarchy termination: stop when typical cubes get too small.
            if len(lg.cubes.counts) and np.median(lg.cubes.counts) < cfg.min_cube_size:
                break
        idx = CubeGraphIndex(cfg, grid, layers, x,
                             torch.as_tensor(s_np, device=dev).float(),
                             norms, np.ones(n, bool))
        idx.build_seconds = time.perf_counter() - t0
        return idx

    @property
    def n(self) -> int:
        return int(self.x.shape[0])

    @property
    def m(self) -> int:
        return int(self.s.shape[1])

    @property
    def n_built_layers(self) -> int:
        return len(self.layers)

    # ------------------------------------------------------------------
    # Query planning (§4.3: layer selection + cube identification)
    # ------------------------------------------------------------------
    def select_layer(self, filt: Filter, layer: Optional[int] = None) -> int:
        if layer is not None:
            return int(np.clip(layer, 0, self.n_built_layers - 1))
        lsel = self.grid.select_layer(filt.characteristic_length())
        return int(np.clip(lsel, 0, self.n_built_layers - 1))

    def _bounds(self, filt: Filter):
        """Filter bounding box conformed to the grid: padded to m dims when
        the filter constrains only a prefix (BallFilter) or a single dim
        (IntervalFilter), then clipped to the global box."""
        blo, bhi = filt.bounding_box()
        blo = np.asarray(blo, np.float64)
        bhi = np.asarray(bhi, np.float64)
        pad = self.grid.m - len(blo)
        if pad > 0:
            blo = np.concatenate([blo, np.full(pad, -np.inf)])
            bhi = np.concatenate([bhi, np.full(pad, np.inf)])
        blo = np.clip(blo[: self.grid.m], self.grid.lo, self.grid.hi)
        bhi = np.clip(bhi[: self.grid.m], self.grid.lo, self.grid.hi)
        return blo, bhi

    def _plan_predetermined(self, filt: Filter, level: int):
        lg = self.layers[level]
        blo, bhi = self._bounds(filt)
        cube_ids = lg.layer.cubes_overlapping_box(blo, bhi)
        rows = lg.cubes.row_of(cube_ids)
        cube_ids = cube_ids[rows >= 0]                     # drop empty cubes
        entries = lg.entry_of_cubes(cube_ids).reshape(-1)
        entries = entries[entries >= 0]
        cap = _next_pow2(max(len(cube_ids), 3 ** self.m, 8))
        active = np.full(cap, -1, np.int64)
        active[: len(cube_ids)] = cube_ids
        seeds = np.full(_next_pow2(max(len(entries), 4)), -1, np.int64)
        seeds[: len(entries)] = entries
        return active, seeds, len(cube_ids)

    def _plan_onthefly(self, filt: Filter, level: int):
        lg = self.layers[level]
        blo, bhi = self._bounds(filt)
        center = (np.asarray(blo) + np.asarray(bhi)) / 2.0
        c0 = int(lg.layer.cube_of(center[None])[0])
        if lg.cubes.row_of(np.asarray([c0]))[0] < 0:
            # entry cube empty: fall back to the nonempty cube nearest (in
            # grid coords) to the filter center.
            cand = lg.cubes.uniq
            cc = lg.layer.unflatten(cand).astype(np.float64)
            target = lg.layer.coords_of(center[None])[0].astype(np.float64)
            c0 = int(cand[np.argmin(((cc - target) ** 2).sum(axis=1))])
        cap = _next_pow2(max(4 * (3 ** self.m), 16))
        active = np.full(cap, -1, np.int64)
        active[0] = c0
        seeds = lg.entry_of_cubes(np.asarray([c0]))[0]
        return active, seeds, 1

    # ------------------------------------------------------------------
    # Query execution
    # ------------------------------------------------------------------
    def query(
        self,
        queries,                        # [b, d]
        filt: Filter,
        k: int = 10,
        ef: int = 64,
        mode: str = "auto",             # auto | predetermined | onthefly
        layer: Optional[int] = None,
        width: int = 4,
        max_iters: int = 512,
        return_stats: bool = False,
        tie_gids=None,                  # [n] optional (dist, gid) tie-break key
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Filtered k-NN -> host ``(ids [b, k] int32, dists [b, k] fp32)``
        (plus :class:`QueryStats` with ``return_stats``)."""
        t0 = time.perf_counter()
        level = self.select_layer(filt, layer)
        lg = self.layers[level]
        if mode == "auto":
            mode = "predetermined" if isinstance(filt, BoxFilter) else "onthefly"
        if mode == "predetermined":
            active, seeds, n_active = self._plan_predetermined(filt, level)
            dynamic = False
        else:
            active, seeds, n_active = self._plan_onthefly(filt, level)
            dynamic = True
        t1 = time.perf_counter()
        params = SearchParams(k=k, ef=ef, width=width, max_iters=max_iters,
                              metric=self.cfg.metric, route_mode="cube",
                              dynamic_cubes=dynamic)
        ids, dists, hops = beam_search(
            self.x, self.s, self.norms, self.valid, lg.cube_of_dev,
            lg.all_nbrs, queries, filt, active, seeds, params,
            tie_key=tie_gids)
        ids = ids.cpu().numpy()
        dists = dists.cpu().numpy()
        t2 = time.perf_counter()
        if return_stats:
            stats = QueryStats(layer=level, n_active_cubes=n_active,
                               elastic_capacity=len(active), mode=mode,
                               plan_ms=(t1 - t0) * 1e3,
                               search_ms=(t2 - t1) * 1e3, hops=hops)
            return ids, dists, stats
        return ids, dists

    # ------------------------------------------------------------------
    # Dynamic updates (§4.4)
    # ------------------------------------------------------------------
    def insert_batch(self, x_new, s_new) -> None:
        """Incremental insertion: per layer, connect new points to their cube
        (occlusion-pruned), add reverse edges (re-pruned), add cross edges."""
        dev = self.device
        x_new = torch.as_tensor(x_new).to(device=dev, dtype=torch.float32)
        s_new_np = np.asarray(s_new, np.float64)
        n_old, n_add = self.n, x_new.shape[0]
        self.x = torch.cat([self.x, x_new], dim=0)
        self.s = torch.cat([self.s, torch.as_tensor(s_new_np, device=dev)
                            .float()], dim=0)
        self.s_np = np.concatenate([self.s_np, s_new_np.astype(self.s_np.dtype)], axis=0)
        self.norms = torch.cat([self.norms, squared_norms(x_new)])
        self.valid = np.concatenate([self.valid, np.ones(n_add, bool)])
        new_ids = np.arange(n_old, n_old + n_add, dtype=np.int32)
        x_all_np = self.x.cpu().numpy()

        for li, lg in enumerate(self.layers):
            m = self.m
            cfg = self.cfg
            coords = lg.layer.coords_of(s_new_np)
            cubes_new = lg.layer.flat_of(coords)
            # -- extend membership table (may add new cubes / grow padding) --
            cube_of = np.concatenate([lg.cube_of, cubes_new])
            cubes = _cube_map(cube_of, x_all_np)

            nbrs = np.concatenate(
                [lg.nbrs.cpu().numpy(),
                 np.full((n_add, cfg.m_intra), -1, np.int32)], axis=0)
            xn = lg.xnbrs.cpu().numpy().reshape(n_old, 2 * m, cfg.m_cross)
            xnbrs = np.concatenate(
                [xn, np.full((n_add, 2 * m, cfg.m_cross), -1, np.int32)], axis=0)

            members = torch.as_tensor(cubes.members, device=dev).long()
            rows_new = cubes.row_of(cubes_new)
            adj_new = _face_adjacent_flat(coords, lg.layer.g)
            adj_rows = cubes.row_of(adj_new)

            k_cand = int(min(2 * cfg.m_intra, max(2, cubes.members.shape[1] - 1)))
            for lo in range(0, n_add, cfg.point_chunk):
                sel = new_ids[lo:lo + cfg.point_chunk]
                sel_t = torch.as_tensor(sel, device=dev).long()
                qv = self.x[sel_t]
                cand = members[torch.as_tensor(
                    rows_new[lo:lo + cfg.point_chunk], device=dev)]
                knn_ids, knn_d = topk_over_candidates(
                    qv, cand, self.x, self.norms, k_cand,
                    exclude=sel_t, col_chunk=cfg.col_chunk,
                    metric=cfg.metric)
                pruned = occlusion_prune(knn_ids, knn_d, self.x, cfg.m_intra)
                nbrs[sel] = pruned.cpu().numpy()
                for direction in range(2 * m):
                    rr = adj_rows[lo:lo + cfg.point_chunk, direction]
                    if np.all(rr < 0):
                        continue
                    cd = cubes.members[np.maximum(rr, 0)].copy()
                    cd[rr < 0] = -1
                    xi, _ = topk_over_candidates(
                        qv, cd, self.x, self.norms, cfg.m_cross,
                        col_chunk=cfg.col_chunk, metric=cfg.metric)
                    xnbrs[sel, direction] = xi.cpu().numpy()

            # -- reverse edges: make new points discoverable -----------------
            src = np.repeat(new_ids, cfg.m_intra)
            dst = nbrs[new_ids].reshape(-1)
            ok = dst >= 0
            src, dst = src[ok], dst[ok]
            if len(dst):
                affected = np.unique(dst)
                # candidates per affected node: current nbrs + new backlinks
                back: dict = {}
                for s_, d_ in zip(src, dst):
                    back.setdefault(d_, []).append(s_)
                r_max = max(len(v) for v in back.values())
                cand_rows = np.full((len(affected), cfg.m_intra + r_max), -1,
                                    np.int32)
                cand_rows[:, :cfg.m_intra] = nbrs[affected]
                for i, a in enumerate(affected):
                    bl = back[a]
                    cand_rows[i, cfg.m_intra:cfg.m_intra + len(bl)] = bl
                aff_t = torch.as_tensor(affected, device=dev).long()
                ci, cd_ = topk_over_candidates(
                    self.x[aff_t], cand_rows, self.x, self.norms,
                    min(cfg.m_intra + r_max, cand_rows.shape[1]),
                    exclude=aff_t, metric=cfg.metric)
                nbrs[affected] = occlusion_prune(
                    ci, cd_, self.x, cfg.m_intra).cpu().numpy()

            self.layers[li] = LayerGraph(
                level=lg.level, layer=lg.layer, cube_of=cube_of, cubes=cubes,
                nbrs=torch.as_tensor(nbrs, device=dev),
                xnbrs=torch.as_tensor(
                    xnbrs.reshape(n_old + n_add, 2 * m * cfg.m_cross),
                    device=dev))

    def delete(self, ids: Sequence[int]) -> None:
        """Lazy deletion (§4.4): O(1) validity-mask update per id."""
        self.valid[np.asarray(ids, np.int64)] = False

    def deleted_fraction(self) -> float:
        return float(1.0 - self.valid.mean())

    def compact(self) -> "CubeGraphIndex":
        """Rebuild over live points (paper: periodic reclamation)."""
        keep = torch.as_tensor(np.nonzero(self.valid)[0], device=self.device)
        return CubeGraphIndex.build(self.x[keep], self.s_np[keep.cpu().numpy()],
                                    self.cfg, device=self.device)

    # ------------------------------------------------------------------
    def index_bytes(self) -> int:
        total = 0
        for lg in self.layers:
            total += lg.nbrs.numel() * 4 + lg.xnbrs.numel() * 4
            total += lg.cube_of.size * 8 + lg.cubes.members.size * 4
        return int(total)

    def stats(self) -> dict:
        return {
            "n": self.n, "m": self.m, "layers": self.n_built_layers,
            "index_MB": self.index_bytes() / 1e6,
            "vector_MB": self.x.numel() * 4 / 1e6,
            "build_seconds": self.build_seconds,
            "per_layer_cubes": [int(lg.cubes.n_nonempty) for lg in self.layers],
        }


# ---------------------------------------------------------------------------
# Persistence: plain npy / npz / json, readable by either package
# ---------------------------------------------------------------------------
def save_index(idx: CubeGraphIndex, directory: str,
               extra_arrays: Optional[dict] = None,
               extra_meta: Optional[dict] = None) -> None:
    """Serialize the full index (vectors, metadata, per-layer graphs).

    The big point arrays (``x``, ``s``, ``valid``) are standalone ``.npy``
    files; the graph arrays go into one ``arrays.npz``.  ``extra_arrays`` /
    ``extra_meta`` attach artifact-level payloads: each extra array lands
    in ``<name>.npy`` and ``extra_meta`` round-trips through ``meta.json``.
    """
    os.makedirs(directory, exist_ok=True)
    np.save(os.path.join(directory, "x.npy"), idx.x.cpu().numpy())
    np.save(os.path.join(directory, "s.npy"), idx.s_np)
    np.save(os.path.join(directory, "valid.npy"), idx.valid)
    for name, arr in (extra_arrays or {}).items():
        np.save(os.path.join(directory, f"{name}.npy"), np.asarray(arr))
    layers = list(enumerate(idx.layers))
    np.savez_compressed(
        os.path.join(directory, "arrays.npz"),
        **{f"l{i}_nbrs": lg.nbrs.cpu().numpy() for i, lg in layers},
        **{f"l{i}_xnbrs": lg.xnbrs.cpu().numpy() for i, lg in layers},
        **{f"l{i}_cube_of": lg.cube_of for i, lg in layers},
        **{f"l{i}_uniq": lg.cubes.uniq for i, lg in layers},
        **{f"l{i}_members": lg.cubes.members for i, lg in layers},
        **{f"l{i}_counts": lg.cubes.counts for i, lg in layers},
        **{f"l{i}_entry": lg.cubes.entry for i, lg in layers},
    )
    meta = {"cfg": dataclasses.asdict(idx.cfg), "n_layers": len(idx.layers),
            "grid": {"lo": idx.grid.lo.tolist(), "hi": idx.grid.hi.tolist(),
                     "n_layers": idx.grid.n_layers},
            "levels": [lg.level for lg in idx.layers],
            "extra": dict(extra_meta or {})}
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_index(directory: str, mmap_mode: Optional[str] = None,
               device=None) -> CubeGraphIndex:
    """Deserialize an index saved by :func:`save_index` (either package's).

    Every array pulled from ``arrays.npz`` is materialized inside the
    ``np.load`` context.  ``mmap_mode`` (e.g. ``"r"``) memory-maps the
    standalone ``x.npy`` / ``s.npy``: the fp64 planning metadata then stays
    disk-backed, while vectors, norms and edges are uploaded to ``device``
    (default: the card).  ``valid`` is always a fresh writable copy.
    """
    dev = resolve_device(device)
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    cfg = CubeGraphConfig(**meta["cfg"])
    grid = GridSpec(lo=np.asarray(meta["grid"]["lo"]),
                    hi=np.asarray(meta["grid"]["hi"]),
                    n_layers=meta["grid"]["n_layers"])
    x_path = os.path.join(directory, "x.npy")
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        if os.path.exists(x_path):
            x_np = np.load(x_path, mmap_mode=mmap_mode)
            s_np = np.load(os.path.join(directory, "s.npy"),
                           mmap_mode=mmap_mode)
            valid = np.array(np.load(os.path.join(directory, "valid.npy")))
        else:                       # legacy artifacts: everything in the npz
            x_np, s_np, valid = z["x"], z["s"], np.array(z["valid"])
        layers = []
        for i, level in enumerate(meta["levels"]):
            cubes = CubeMap(uniq=np.array(z[f"l{i}_uniq"]),
                            members=np.array(z[f"l{i}_members"]),
                            counts=np.array(z[f"l{i}_counts"]),
                            entry=np.array(z[f"l{i}_entry"]))
            layers.append(LayerGraph(
                level=level, layer=grid.layer(level),
                cube_of=np.array(z[f"l{i}_cube_of"]), cubes=cubes,
                nbrs=torch.as_tensor(np.array(z[f"l{i}_nbrs"]), device=dev),
                xnbrs=torch.as_tensor(np.array(z[f"l{i}_xnbrs"]),
                                      device=dev)))
    # np.array copies: a read-only memmap is never handed to torch, which
    # would alias it on the CPU
    x = torch.as_tensor(np.array(x_np, np.float32), device=dev)
    idx = CubeGraphIndex(cfg, grid, layers, x,
                         torch.as_tensor(np.array(s_np, np.float32),
                                         device=dev),
                         squared_norms(x), valid)
    idx.s_np = s_np          # fresh array (or caller-requested memmap view)
    return idx


def load_index_extras(directory: str, names: Sequence[str],
                      mmap_mode: Optional[str] = None):
    """(arrays dict for ``names``, extra_meta dict) attached by
    :func:`save_index` — the artifact-level payload without the index."""
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    arrays = {name: np.load(os.path.join(directory, f"{name}.npy"),
                            mmap_mode=mmap_mode) for name in names}
    return arrays, meta.get("extra", {})

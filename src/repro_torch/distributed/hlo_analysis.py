"""Roofline accounting of one dry-run cell — the counterpart of
``repro.distributed.hlo_analysis``.

The reference reads XLA's ``cost_analysis`` and parses the compiled HLO
text for collectives.  The port runs the cell eagerly on fake local
shards (``launch/dryrun.py``) under :class:`CostCounter`, a dispatch mode
that sees every op *below* ``DTensor``, on one rank's local shards, and
records per device, as the reference does:

* ``flops``: the matmul / convolution / attention FLOPs of each op, by
  the formulas of ``torch.utils.flop_counter`` (elementwise ops count 0);
* ``bytes``: every non-view op's tensor inputs read once and its new
  outputs written once (the counterpart of XLA's "bytes accessed");
* collectives: each ``_c10d_functional`` collective with its output's
  shape, dtype and bytes (the reference counts an HLO collective's result
  shape); ``collective_bytes`` sums them by kind;
* memory: the bytes of live storages, arguments included, and their peak.

``depth_delta`` and ``roofline_terms`` are the reference's arithmetic.
Eager mode counts every layer, so a cell's full-depth numbers are read
directly; the dry run still fills ``delta`` by the reference's two-depth
method so that the records compare.
"""
from __future__ import annotations

import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..training.tree import leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# torch's functional collectives, by the reference's HLO kinds.  DTensor
# has no permute collective, so "collective-permute" stays 0.
_FUNCOL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(obj) -> list:
    """The tensors among ``obj``'s leaves (dicts, lists and tuples
    walked)."""
    return [t for t in leaves(obj) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Per-device flops, bytes, collectives and live-memory peak of the
    ops run inside it (see the module docstring).  Ops on ``DTensor``s are
    handed to ``DTensor`` first, so the counter sees the local ops and
    collectives they turn into.  ``DTensor``'s sharding propagation runs
    ops on fake tensors to learn output shapes, once per new op signature
    (then it is cached): the counter pauses inside it, so that a cell
    counts the same whether or not an earlier one warmed the cache.  With
    ``fake_mode`` set, only ops that run under that fake mode count."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        self.collectives: list = []
        self.live = 0
        self.peak = 0
        self.paused = 0          # > 0: ops run but are not counted
        self._storages: Dict[int, tuple] = {}

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        cached = prop.propagate_op_sharding
        uncached = prop.propagate_op_sharding_non_cached
        counter = self

        def paused(fn):
            def call(*args, **kwargs):
                counter.paused += 1
                try:
                    return fn(*args, **kwargs)
                finally:
                    counter.paused -= 1
            return call

        class Cached:
            __call__ = staticmethod(paused(cached))

            def cache_clear(self):
                return cached.cache_clear()

        prop.propagate_op_sharding = Cached()
        prop.propagate_op_sharding_non_cached = paused(uncached)
        self._restore = (prop, cached)
        return super().__enter__()

    def __exit__(self, *exc):
        prop, cached = self._restore
        prop.propagate_op_sharding = cached
        del prop.propagate_op_sharding_non_cached
        return super().__exit__(*exc)

    # -- live memory ---------------------------------------------------------
    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (``DTensor``s by their
        local shards) as live; returns the bytes newly counted."""
        from torch.distributed.tensor import DTensor
        added = 0
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages and self._storages[key][0]() is st:
                continue
            n = st.nbytes()

            def gone(_ref, key=key, n=n):
                if self._storages.pop(key, None) is not None:
                    self.live -= n
            self._storages[key] = (weakref.ref(st, gone), n)
            self.live += n
            added += n
        self.peak = max(self.peak, self.live)
        return added

    # -- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default \
                and self.fake_mode is not None:
            # the fake impl returns a new tensor; eager waits in place
            return args[0]
        out = func(*args, **kwargs)
        if self.paused or (self.fake_mode is not None
                           and active_fake_mode() is not self.fake_mode):
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional" and name in _FUNCOL_KINDS:
            for t in _tensors(out):
                self.collectives.append({
                    "kind": _FUNCOL_KINDS[name], "shape": list(t.shape),
                    "dtype": str(t.dtype).replace("torch.", ""),
                    "bytes": _nbytes(t)})
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            ins = _tensors(args) + _tensors(kwargs)
            in_ids = {id(t) for t in ins}
            self.bytes += sum(_nbytes(t) for t in ins)
            self.bytes += sum(_nbytes(t) for t in _tensors(out)
                              if id(t) not in in_ids)
        self.track(out)
        return out


def collective_bytes(records: Iterable[dict]) -> Dict[str, int]:
    """Sum the output bytes per collective kind over a cell's collective
    records (``CostCounter.collectives``): the reference's dict, the five
    kinds plus ``count`` and ``total``.  For an all-gather the gathered
    size counts, for a reduce-scatter the scattered one."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    for r in records:
        out[r["kind"]] += int(r["bytes"])
        out["count"] += 1
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def flops_and_bytes(counter: CostCounter) -> Dict[str, float]:
    """Per-device flops / bytes of a counted cell (the reference reads
    them from ``compiled.cost_analysis()``)."""
    return {"flops": float(counter.flops), "bytes": float(counter.bytes)}


def depth_delta(cost_u, cost_u1, coll_u, coll_u1, u: int, full_depth: int
                ) -> Dict[str, float]:
    """Linear extrapolation: total(full) = base + full_depth * delta."""
    out = {}
    for key in ("flops", "bytes"):
        delta = cost_u1[key] - cost_u[key]
        base = cost_u[key] - u * delta
        out[key] = base + full_depth * delta
        out[key + "_per_layer"] = delta
    dcol = coll_u1["total"] - coll_u["total"]
    bcol = coll_u["total"] - u * dcol
    out["collective_bytes"] = bcol + full_depth * dcol
    out["collective_bytes_per_layer"] = dcol
    return out


def roofline_terms(flops: float, bytes_: float, coll_bytes: float,
                   chips: int, peak_flops: float, hbm_bw: float,
                   ici_bw: float, per_device: bool = True) -> Dict[str, float]:
    """The three roofline terms in seconds.  The counted numbers are per
    device, so divide only when asked."""
    div = 1 if per_device else chips
    t_compute = flops / div / peak_flops
    t_memory = bytes_ / div / hbm_bw
    t_coll = coll_bytes / div / ici_bw
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_coll), key=lambda kv: kv[1])
    return {"compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll, "bottleneck": dom[0]}

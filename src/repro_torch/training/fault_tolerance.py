"""Cluster-runtime fault handling: heartbeats, straggler detection, and the
elastic restart plan.

At 1000+ nodes the failure model is: (a) hard node loss — detected by missed
heartbeats, handled by checkpoint-restore onto the surviving mesh (elastic);
(b) stragglers — detected by per-step-time outliers, handled by excluding the
slow host from the next mesh or, within a step, by bounded collect timeouts.
On this single-process container the *policies* are fully implemented and
unit-tested against simulated timing traces; the transport (real heartbeat
RPCs) is the thin layer a deployment supplies.

The counterpart of ``repro.training.fault_tolerance``: host policies,
copied as they are.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HeartbeatConfig:
    interval_s: float = 10.0
    miss_threshold: int = 3            # missed beats => dead
    straggler_factor: float = 2.0      # step_time > f * median => straggler
    straggler_window: int = 20         # sliding window of step times


class HeartbeatMonitor:
    """Tracks liveness + per-host step times; pure logic (testable)."""

    def __init__(self, hosts: Sequence[int], cfg: HeartbeatConfig = HeartbeatConfig()):
        self.cfg = cfg
        self.last_beat: Dict[int, float] = {h: time.monotonic() for h in hosts}
        self.step_times: Dict[int, deque] = {
            h: deque(maxlen=cfg.straggler_window) for h in hosts}

    def beat(self, host: int, step_time_s: Optional[float] = None,
             now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self.last_beat[host] = now
        if step_time_s is not None:
            self.step_times[host].append(step_time_s)

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        limit = self.cfg.interval_s * self.cfg.miss_threshold
        return [h for h, t in self.last_beat.items() if now - t > limit]

    def stragglers(self) -> List[int]:
        medians = []
        for times in self.step_times.values():
            if times:
                medians.extend(times)
        if not medians:
            return []
        medians.sort()
        med = medians[len(medians) // 2]
        out = []
        for h, times in self.step_times.items():
            if times and (sum(times) / len(times)) > self.cfg.straggler_factor * med:
                out.append(h)
        return out


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Given surviving chips, the largest runnable production mesh and the
    batch re-sharding plan (global batch is preserved; per-replica batch
    grows as the data axis shrinks)."""

    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    data_parallel: int
    notes: str = ""


def plan_elastic_mesh(n_chips: int, model_parallel: int = 16,
                      pods: int = 1) -> ElasticPlan:
    """Shrink the data axis to the largest power-of-two that fits the
    surviving chip count, keeping TP (model axis) intact — TP must not change
    because parameter layouts are sharded along it."""
    per_pod = n_chips // max(pods, 1)
    data = 1
    while data * 2 * model_parallel <= per_pod:
        data *= 2
    if pods > 1:
        return ElasticPlan((pods, data, model_parallel),
                           ("pod", "data", "model"), data * pods,
                           notes=f"{n_chips} chips -> ({pods},{data},{model_parallel})")
    return ElasticPlan((data, model_parallel), ("data", "model"), data,
                       notes=f"{n_chips} chips -> ({data},{model_parallel})")


class FaultTolerantRunner:
    """Training-loop supervisor: periodic checkpoints, failure detection
    hooks, restore-and-reshard on simulated node loss.  See
    tests/test_torch_checkpoint.py and launch/train.py."""

    def __init__(self, ckpt_manager, monitor: HeartbeatMonitor,
                 ckpt_every: int = 50):
        self.ckpt = ckpt_manager
        self.monitor = monitor
        self.ckpt_every = ckpt_every
        self.failures_handled = 0

    def maybe_checkpoint(self, step: int, state, data_step: int):
        if step % self.ckpt_every == 0 and step > 0:
            self.ckpt.save(step, state, extra={"data_step": data_step})

    def check_cluster(self, now: Optional[float] = None) -> Dict:
        dead = self.monitor.dead_hosts(now)
        strag = self.monitor.stragglers()
        return {"dead": dead, "stragglers": strag,
                "action": ("elastic_restart" if dead else
                           "exclude_stragglers" if strag else "none")}

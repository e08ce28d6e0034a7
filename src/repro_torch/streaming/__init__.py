"""Streaming temporal index: LSM-style segment lifecycle for CubeGraph.

- ``segments``    delta buffer (exact kernel scan) + sealed
                  ``CubeGraphIndex`` time-range partitions, both speaking
                  global point ids, plus the chunked GC-able ``PointStore``
- ``manager``     seal policy, off-path compaction (plan/execute/publish
                  with an epoch guard), TTL expiry, point-store GC
- ``query``       temporal segment pruning + per-segment graph search or
                  the sharded pack (scan / int8 scan + rerank / stitched
                  traversal) + exact ``(gid, dist)`` merge
- ``planner``     per-bucket scan-vs-traversal (and cold host_scan) cost
                  planner
- ``persistence`` WAL + segment artifacts + atomic manifest, crash
                  recovery, in the JAX package's on-disk format
- ``tiering``     device memory as a budgeted cache over the bucketed pack
                  (TierState residency policy, time-window prefetch)
- ``resilience``  fault injection at named fault points, supervised
                  background workers and query deadlines
"""
from .manager import CompactionPlan, SegmentManager, StreamConfig
from .persistence import (RestoreError, StreamPersistence, WriteAheadLog,
                          load_manifest, restore_manager)
from .query import (GroupQuery, merge_topk, query_segments,
                    query_segments_grouped, temporal_bounds)
from .resilience import (FAULT_POINTS, Deadline, FaultError, FaultInjector,
                         QueryResult, Supervisor)
from .segments import (DeltaBuffer, DeltaSnapshot, PointStore, SealedSegment,
                       SegmentQueryStats)
from .tiering import TierState

__all__ = [
    "CompactionPlan", "SegmentManager", "StreamConfig",
    "DeltaBuffer", "DeltaSnapshot", "PointStore", "SealedSegment",
    "SegmentQueryStats",
    "merge_topk", "query_segments", "temporal_bounds", "GroupQuery",
    "query_segments_grouped",
    "RestoreError", "StreamPersistence", "WriteAheadLog", "load_manifest",
    "restore_manager",
    "TierState",
    "FAULT_POINTS", "FaultError", "FaultInjector", "Deadline", "QueryResult",
    "Supervisor",
]

"""Streaming temporal index: LSM-style segment lifecycle for CubeGraph.

- ``segments``    delta buffer (exact kernel scan) + sealed
                  ``CubeGraphIndex`` time-range partitions, both speaking
                  global point ids, plus the chunked GC-able ``PointStore``
- ``manager``     seal policy, off-path compaction (plan/execute/publish
                  with an epoch guard), TTL expiry, point-store GC
- ``query``       temporal segment pruning + per-segment graph search or
                  the sharded pack (scan / int8 scan + rerank / stitched
                  traversal) + exact ``(gid, dist)`` merge
- ``planner``     per-bucket scan-vs-traversal cost planner
- ``resilience``  supervised background workers and query deadlines
"""
from .manager import CompactionPlan, SegmentManager, StreamConfig
from .query import merge_topk, query_segments, temporal_bounds
from .resilience import Deadline, QueryResult, Supervisor
from .segments import (DeltaBuffer, DeltaSnapshot, PointStore, SealedSegment,
                       SegmentQueryStats)

__all__ = [
    "CompactionPlan", "SegmentManager", "StreamConfig",
    "DeltaBuffer", "DeltaSnapshot", "PointStore", "SealedSegment",
    "SegmentQueryStats",
    "merge_topk", "query_segments", "temporal_bounds",
    "Deadline", "QueryResult", "Supervisor",
]

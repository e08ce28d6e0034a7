"""Rows per second of the set-up's ingest: ``SegmentManager.ingest`` and
``maintenance`` (seal, graph build, compaction, pack deltas), host clock."""


def read(r):
    return r.ingest_rows_per_s if r.ingest_rows_per_s > 0 else None

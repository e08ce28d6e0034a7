"""Sharded sealed-segment storage: the size-bucketed shard pack, its delta
protocol, the per-bucket kernel dispatch and the multi-card shard mesh
(``segment_shards``); and the mesh side of training: the sharding rules
as ``DTensor`` placements (``sharding``), the mesh hints model code calls
(``hints``) and the dry run's per-device accounting (``hlo_analysis``)."""
from .segment_shards import (BucketedShardPack, BucketView, PackView,
                             SegmentShardSource, ShardMesh, ShardPack,
                             bucket_cap_for,
                             bucket_graph_seeds, build_bucketed_pack,
                             build_shard_pack, host_topk, make_shard_mesh,
                             pack_search, pack_search_blocks,
                             pack_search_blocks_grouped)

__all__ = ["BucketedShardPack", "BucketView", "PackView",
           "SegmentShardSource", "ShardMesh", "ShardPack", "bucket_cap_for",
           "bucket_graph_seeds", "build_bucketed_pack", "build_shard_pack",
           "host_topk", "make_shard_mesh", "pack_search",
           "pack_search_blocks", "pack_search_blocks_grouped"]

"""CubeGraph core in PyTorch: filters, the hierarchical grid, graph build,
beam search and the index API — the counterpart of ``repro.core`` — plus
the paper's baselines (PostFiltering / PreFiltering / ACORN / TreeGraph,
``core.baselines``)."""
from .baselines import (AcornIndex, MonolithicGraphIndex, PostFilteringIndex,
                        PreFilteringIndex, TreeGraphIndex)
from .cubegraph import (CubeGraphConfig, CubeGraphIndex, QueryStats,
                        load_index, load_index_extras, save_index)
from .filters import (BallFilter, BoxFilter, ComposeFilter, Filter,
                      IntervalFilter, PolygonFilter)
from .grid import GridSpec, Layer
from .search import SearchParams, beam_search

__all__ = [
    "AcornIndex", "MonolithicGraphIndex", "PostFilteringIndex",
    "PreFilteringIndex", "TreeGraphIndex",
    "CubeGraphConfig", "CubeGraphIndex", "QueryStats",
    "BallFilter", "BoxFilter", "ComposeFilter", "Filter", "IntervalFilter",
    "PolygonFilter",
    "GridSpec", "Layer", "SearchParams", "beam_search",
    "load_index", "load_index_extras", "save_index",
]

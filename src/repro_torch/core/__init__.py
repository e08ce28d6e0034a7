"""CubeGraph core in PyTorch: filters, the hierarchical grid, graph build,
beam search and the index API — the counterpart of ``repro.core``."""
from .cubegraph import (CubeGraphConfig, CubeGraphIndex, QueryStats,
                        load_index, load_index_extras, save_index)
from .filters import (BallFilter, BoxFilter, ComposeFilter, Filter,
                      IntervalFilter, PolygonFilter)
from .grid import GridSpec, Layer
from .search import SearchParams, beam_search

__all__ = [
    "CubeGraphConfig", "CubeGraphIndex", "QueryStats",
    "BallFilter", "BoxFilter", "ComposeFilter", "Filter", "IntervalFilter",
    "PolygonFilter",
    "GridSpec", "Layer", "SearchParams", "beam_search",
    "load_index", "load_index_extras", "save_index",
]

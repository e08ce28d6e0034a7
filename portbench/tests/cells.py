"""Cells of ``BENCHMARK.json`` cut to CPU test sizes."""
import copy


def small_cell(name: str, live_rows: int = 1200, d: int = 64,
               batch: int = 64, pool: int = 2):
    """A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
    its own limits, traffic recipe and stream settings, a smaller corpus,
    width and batch, and segments of 256 rows."""
    from portbench import spec
    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(live_rows=live_rows, d=d, ingest_batch=512)
    cell.config["stream"]["seal_max_points"] = 256
    cell.traffic = dict(cell.traffic, batch=batch, pool=pool)
    return cell

"""Production mesh definitions and the roofline's hardware constants —
the counterpart of ``repro.launch.mesh``.

``make_production_mesh`` is a function, not a module-level constant, so
that importing this module touches no process group: the dry run builds
the mesh over a ``fake`` process group of the mesh's size, a training
run over its real one.
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "HW"]

SHAPES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """A ``DeviceMesh`` of the reference's shapes over the default
    process group: (16, 16) with axes ("data", "model"), or (2, 16, 16)
    with ("pod", "data", "model") when ``multi_pod``.  The single-pod mesh
    takes the first 256 ranks of a larger world; a world smaller than the
    mesh raises."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = SHAPES[multi_pod]
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the default process group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


class HW:
    """One NVIDIA H100 SXM5 80GB, the roofline's constants (per card)."""

    # NVIDIA H100 Tensor Core GPU data sheet, SXM column, dense (no
    # sparsity): BF16 Tensor Core 1,979 TFLOP/s with sparsity, half dense.
    PEAK_BF16_FLOPS = 989.4e12     # FLOP/s
    # The same data sheet: FP32 outside the tensor cores, 67 TFLOP/s.
    PEAK_FP32_FLOPS = 67e12        # FLOP/s
    # The same data sheet: GPU memory bandwidth 3.35 TB/s (HBM3).
    HBM_BW = 3.35e12               # bytes/s
    # The same data sheet: NVLink 900 GB/s, both directions together; one
    # direction, in the role of the reference's per-link ICI_BW.
    ICI_BW = 450e9                 # bytes/s
    # The card's memory as torch reads it on an H100 80GB HBM3
    # (torch.cuda.get_device_properties(0).total_memory; chip_smoke.py
    # phase 10 prints it); the data sheet says 80 GB.
    HBM_BYTES = 85_017_493_504     # capacity

"""PyTorch/CUDA port of the CubeGraph system (``repro`` is the JAX
reference).

Entry points take ``device=`` and default to the first CUDA card; pass
``device="cpu"`` to run the kernels' plain PyTorch twins on the CPU.  The
package imports neither ``jax`` nor ``repro``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]

"""PyTorch/CUDA port of the FastFlow reproduction (``repro``).

The JAX package ``repro`` stays the reference; this package is its
counterpart for an NVIDIA H100, built one slice at a time.  It imports
torch, numpy and the standard library, never ``jax`` and nothing of
``repro``.  The first slice is the paper's application: Smith-Waterman
protein database search streamed through an order-preserving farm.

* :mod:`repro_torch.core` — the streaming runtime (threads backend).
* :mod:`repro_torch.kernels.ops` — ``smith_waterman`` and its front end.
* :mod:`repro_torch.kernels.smith_waterman` — the CUDA kernel's wrapper,
  its plain PyTorch version and its launch count.
* :mod:`repro_torch.convert` — carries arrays from the reference across.

Importing this package loads nothing heavy: subpackages are imported on
use.
"""

"""mcmctoffitting_tpu_torch — the PyTorch/CUDA port of mcmctoffitting_tpu.

The JAX package ``mcmctoffitting_tpu`` is the reference; this package runs
the same fits on an NVIDIA GPU (Hopper, ``sm_90a``) and is tested against
it.  The layout mirrors the JAX package (``ops`` -> ``models`` ->
``sampler`` -> ``utils``) with the same module and function names where they
mean the same thing.

Rules of the port:

* it imports ``torch`` and never ``jax``, and nothing of the JAX package:
  it keeps its own copies of ``constants`` and ``config``;
* every op is batch-native: a leading walker axis, then a run axis,
  ``(W, R, ...)``;
* every hand-written kernel (``csrc/``, wrapped in ``ops/cuda_*.py``)
  dispatches on the device of its input alone: a CPU tensor takes the
  kernel's plain PyTorch version, a CUDA tensor launches the kernel or
  raises — there is no fallback;
* entry points run on the card (``device='cuda'``) unless the caller asks
  for the CPU; random generators are always passed explicitly.
"""

__version__ = "0.1.0"

from . import config, constants  # noqa: F401

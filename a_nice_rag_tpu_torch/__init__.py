"""a_nice_rag_tpu_torch — the PyTorch/CUDA port of a_nice_rag_tpu.

Mirrors the JAX package's module paths and public names so each
counterpart is easy to find. Plain tensor code is PyTorch; the streaming
score+top-k kernels that the JAX package wrote for the TPU are
CUDA C++ for Hopper (``csrc/``, bound in ``ops/kernels``). Every function
takes its device explicitly from the tensors or a ``device`` argument;
nothing falls back from CUDA to the CPU.

This package never imports jax. The JAX package stays the reference that
the tests hold this one against.
"""

__version__ = "0.1.0"

from a_nice_rag_tpu_torch.device import require_cuda, resolve_device  # noqa: F401

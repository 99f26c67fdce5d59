"""hakai_tpu_torch: the PyTorch + CUDA port of hakai_tpu.

The tensile-bar main path (lowering, state, the packed central-difference
chunk loop) runs on one NVIDIA GPU through two hand-written CUDA kernels,
the fused per-element update (``csrc/element.cu``) and the deterministic
nodal assembly (``csrc/assemble.cu``).  On CPU tensors every kernel
wrapper runs its plain PyTorch version instead.

The JAX package ``hakai_tpu`` is the reference the port is held against;
the port reuses its NumPy-only modules (``config``, ``io.model``,
``pre.synthetic``, ``ops.shape``, ``core.renumber``) and never imports jax.
"""
from .core.lowering import LoweredModel, lower
from .core.state import SimState, init_state
from .solver.explicit import run_chunk

__all__ = ["LoweredModel", "SimState", "init_state", "lower", "run_chunk"]

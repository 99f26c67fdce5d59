"""hakai_tpu_torch: the PyTorch + CUDA port of hakai_tpu.

The tensile-bar path runs on one NVIDIA GPU in float32, float64 or mixed
precision (float64 nodal state, float32 element math), with ductile
fracture: lowering, state, the packed central-difference chunk loop and the
host loop ``run()`` with VTK frames, checkpoints and metrics.  Two
hand-written CUDA kernels carry the step: the fused per-element update
(``csrc/element.cu``) and the deterministic nodal assembly
(``csrc/assemble.cu``).  On CPU tensors every kernel wrapper runs its plain
PyTorch version instead; the entry points run on the GPU unless called with
``device="cpu"``.

The JAX package ``hakai_tpu`` is the reference the port is held against.
The port imports nothing of it and never imports jax: it keeps its own
copies of the NumPy-only modules it needs (``config``, ``io.model``,
``pre.synthetic``, ``ops.shape``, ``core.renumber``).
"""
from .config import SolverConfig
from .core.lowering import LoweredModel, lower
from .core.state import SimState, init_state
from .solver.explicit import run, run_chunk

__all__ = ["LoweredModel", "SimState", "SolverConfig", "init_state", "lower",
           "run", "run_chunk"]

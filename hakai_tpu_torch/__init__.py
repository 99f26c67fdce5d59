"""hakai_tpu_torch: the PyTorch + CUDA port of hakai_tpu.

``python -m hakai_tpu_torch deck.inp`` reads an Abaqus deck, lowers it and
runs it on one NVIDIA GPU in float32, float64 or mixed precision (float64
nodal state, float32 element math), with ductile fracture and penalty
contact: lowering, state, the generic step and the packed
central-difference chunk loop, and the host loop ``run()`` with VTK
frames, checkpoints and metrics.  Hand-written CUDA kernels carry the
step: the fused per-element update (``csrc/element.cu``, packed and
unpacked entries), the deterministic nodal assembly (``csrc/assemble.cu``)
and the contact gather, narrow phase and scatter (``csrc/gather.cu``,
``csrc/contact.cu``).  On CPU tensors every kernel wrapper runs its plain
PyTorch version instead; the entry points run on the GPU unless called with
``device="cpu"``.

The JAX package ``hakai_tpu`` is the reference the port is held against.
The port imports nothing of it and never imports jax: it keeps its own
copies of the NumPy-only modules it needs (``config``, ``io.model``,
``io.inp``, ``pre.synthetic``, ``ops.shape``, ``core.renumber``, the
offline tools ``pre.gilgamsh``, ``pre.shell_to_solid``, ``pre.viewer`` and
``utils.plot``) and its own copy of the C++ host-IO helper
(``csrc/host_io.cpp``, bound by ``io.native``).
"""
from .config import SolverConfig
from .core.lowering import LoweredModel, lower
from .core.state import SimState, init_state
from .io.inp import parse_inp_lines, read_inp_file
from .io.model import Model
from .solver.explicit import run, run_chunk, step

__all__ = ["LoweredModel", "Model", "SimState", "SolverConfig", "init_state",
           "lower", "parse_inp_lines", "read_inp_file", "run", "run_chunk",
           "step"]

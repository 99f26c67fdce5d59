"""The port runs without JAX: a fresh interpreter imports hakai_tpu_torch,
lowers and steps the bar on the CPU, and never imports jax."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import torch
import hakai_tpu_torch as ht
from hakai_tpu.config import SolverConfig
from hakai_tpu.pre.synthetic import bar_model
m = ht.lower(bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4),
             SolverConfig(dtype="float32"))
s = ht.run_chunk(m, ht.init_state(m), 5)
assert int(s.t) == 5 and bool(torch.isfinite(s.disp).all())
print("JAX_IMPORTED", "jax" in sys.modules)
"""


def test_port_never_imports_jax():
    r = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "JAX_IMPORTED False" in r.stdout, r.stdout

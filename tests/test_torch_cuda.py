"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the fixture) where there is no
CUDA device.  The file imports only the port, so it runs on a GPU machine
with nvcc and without JAX (``--noconftest`` skips ``tests/conftest.py``,
which configures JAX):
    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from hakai_tpu_torch import SolverConfig, init_state, lower, run_chunk
from hakai_tpu_torch.ops.assemble_cuda import assemble_internal_force
from hakai_tpu_torch.ops.element import (assemble_internal_force_plain,
                                         element_core_packed_plain)
from hakai_tpu_torch.ops.element_cuda import element_core_packed
from hakai_tpu_torch.pre.synthetic import bar_model

pytestmark = pytest.mark.cuda

# normwise kernel-vs-plain tolerance: same formulas, other association order
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the triaxiality mean/vm: a quotient with cancelling deviatoric
# differences, 10x the element bound
TRIAX_TOL = {torch.float32: 1e-4, torch.float64: 1e-11}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    E, N = m.E, m.N
    disp = rng.normal(scale=1e-3, size=(3, N))
    P = np.concatenate([rng.normal(scale=300.0, size=(48, E)),
                        rng.normal(scale=1e-3, size=(6, E)), np.zeros((2, E)),
                        rng.uniform(0.0, 0.3, (8, E)),
                        755.0 + rng.uniform(0.0, 300.0, (8, E))])
    flag = m.elem_exists.clone()
    flag[1] = False

    def t(a, dt):
        return torch.as_tensor(a, device=m.device).to(dt).contiguous()
    return (t(P, m.edtype), flag, t(disp, m.dtype),
            t(disp + rng.normal(scale=2e-4, size=(3, N)), m.dtype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_element_kernel_matches_plain(cuda, dtype):
    m = lower(bar_model(8, 8, 32), SolverConfig(dtype=dtype, elem_pad=4096),
              device=cuda)
    args = _inputs(m, 1)
    before = element_core_packed.launches
    Pk, qk = element_core_packed(m, *args)
    Pp, qp = element_core_packed_plain(m, *args)
    assert element_core_packed.launches == before + 1
    assert _rel(Pk, Pp) <= TOL[m.dtype] and _rel(qk, qp) <= TOL[m.dtype]
    assert not Pk[54:56].any() and not qk[:, ~args[1]].any()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_assembly_kernel_matches_plain(cuda, dtype):
    m = lower(bar_model(8, 8, 32), SolverConfig(dtype=dtype), device=cuda)
    qe = torch.randn(24, m.E, dtype=m.dtype, device=cuda)
    Q = assemble_internal_force(m, qe)
    assert _rel(Q, assemble_internal_force_plain(m, qe)) <= TOL[m.dtype]
    assert torch.equal(Q, assemble_internal_force(m, qe))   # no atomics


def test_wrappers_refuse_wrong_inputs(cuda):
    m = lower(bar_model(4, 4, 16), SolverConfig(dtype="float32"), device=cuda)
    P, flag, disp, dprev = _inputs(m, 2)
    with pytest.raises(TypeError):
        element_core_packed(m, P.double(), flag, disp, dprev)
    with pytest.raises(ValueError):
        element_core_packed(m, P[:, :8], flag, disp, dprev)
    with pytest.raises(ValueError):
        assemble_internal_force(m, torch.zeros(24, m.E + 8, device=cuda))


def test_run_chunk_card_matches_cpu_f64(cuda):
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4)
    cfg = SolverConfig(dtype="float64")
    mg, mc = lower(bar, cfg, device=cuda), lower(bar, cfg, device="cpu")
    g = run_chunk(mg, init_state(mg), 50)
    c = run_chunk(mc, init_state(mc), 50)
    assert c.eq_ps.max() > 0
    for name in ("disp", "velo", "stress", "eq_ps", "yield_s", "triax"):
        assert _rel(getattr(g, name).cpu(), getattr(c, name)) <= 1e-10, name


@pytest.mark.parametrize("dtype", ["float32", "float64", "mixed"])
def test_element_kernel_triax_matches_plain(cuda, dtype):
    """Every instantiation with the triaxiality output (mixed: float64
    disp/dprev, float32 math), against the plain twin."""
    m = lower(bar_model(8, 8, 32, ductile=True),
              SolverConfig(dtype=dtype, elem_pad=4096), device=cuda)
    args = _inputs(m, 3)
    before = dict(element_core_packed.launches_by)
    Pk, qk, tk = element_core_packed(m, *args, want_triax=True)
    Pp, qp, tp = element_core_packed_plain(m, *args, want_triax=True)
    variant = "mixed" if dtype == "mixed" else dtype
    assert (element_core_packed.launches_by[variant + "+triax"]
            == before[variant + "+triax"] + 1)
    assert Pk.dtype == qk.dtype == tk.dtype == m.edtype
    assert tk.shape == (8, m.E)
    assert _rel(Pk, Pp) <= TOL[m.edtype] and _rel(qk, qp) <= TOL[m.edtype]
    assert _rel(tk, tp) <= TRIAX_TOL[m.edtype]


def test_mixed_assembly_stores_float64(cuda):
    """Mixed precision: the float32 sum is stored as float64, with the bits
    of the float32 kernel's sum cast afterwards."""
    m = lower(bar_model(8, 8, 32), SolverConfig(dtype="mixed"), device=cuda)
    qe = torch.randn(24, m.E, dtype=torch.float32, device=cuda)
    Q = assemble_internal_force(m, qe, torch.float64)
    assert Q.dtype == torch.float64 and Q.shape == (3, m.N)
    assert torch.equal(Q, assemble_internal_force(m, qe).double())
    assert _rel(Q, assemble_internal_force_plain(m, qe).double()) <= 1e-6


def test_mixed_fracture_run_chunk_card_matches_cpu(cuda):
    """The ductile bar in mixed precision for 500 steps (past the first
    deletions, at step 454 on the CPU) on the card and on the CPU: equal
    flags, and each state field within 10x the float32 envelope (the CPU
    mixed run against the CPU float64 run)."""
    bar = bar_model(4, 4, 16, d_time=5e-8, end_time=1e-4, ductile=True)
    out = {}
    for dev, dt in ((cuda, "mixed"), ("cpu", "mixed"), ("cpu", "float64")):
        m = lower(bar, SolverConfig(dtype=dt), device=dev)
        out[(str(dev), dt)] = run_chunk(m, init_state(m), 500)
    g, c, c64 = out[("cuda", "mixed")], out[("cpu", "mixed")], \
        out[("cpu", "float64")]
    assert g.disp.dtype == g.Q.dtype == torch.float64
    assert g.stress.dtype == torch.float32
    assert not c.element_flag.all()
    assert torch.equal(g.element_flag.cpu(), c.element_flag)
    for name in ("disp", "velo", "Q", "stress", "eq_ps", "triax"):
        env = max(_rel(getattr(c, name).double(),
                       getattr(c64, name).double()), 2.0 ** -23)
        err = _rel(getattr(g, name).cpu().double(),
                   getattr(c, name).double())
        assert err <= 10 * env, (name, err, env)

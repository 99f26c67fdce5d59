"""The port's erosion (hakai_tpu_torch.ops.erosion) against the JAX
package's, bitwise: the table walk is the same sequence of float32 or
float64 operations (Gauss-point means in the order k = 0..7, the segment
interpolation with Python-scalar knots), so every decision must agree."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hakai_tpu.ops import erosion as jer
from hakai_tpu_torch.ops import erosion as ter

# material 0: the synthetic bar's table; material 1: no ductile table
# (never erodes); material 2: three rows, a vertical segment and a knot
# exactly representable in binary
DU_TABLES = (((1.0, 0.0), (0.3, 0.3)),
             (),
             ((1.2, -0.5), (0.8, 0.0), (0.8, 0.0), (0.4, 0.5)))
KNOTS = (0.0, 0.3, -0.5, 0.5)


def _inputs(dtype, E=4096, seed=17):
    """eq_ps / triax per Gauss point, flags and material ids.  Elements
    16k..16k+3 put every Gauss point exactly on a knot; eq_ps spans the
    fracture strains; triax spans negative values; about a tenth of the
    elements are already dead."""
    rng = np.random.default_rng(seed)
    eq = rng.uniform(0.0, 1.4, (8, E))
    tri = rng.uniform(-0.7, 0.8, (8, E))
    for i, knot in enumerate(KNOTS):
        tri[:, i::16] = knot
        eq[:, i + 4::16] = eq[0, i + 4::16]      # equal GP strains
    flag = rng.uniform(size=E) > 0.1
    mat = rng.integers(0, len(DU_TABLES), E).astype(np.int32)
    return eq.astype(dtype), tri.astype(dtype), flag, mat


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_delete_mask_bitwise(dtype):
    eq, tri, flag, mat = _inputs(dtype)
    jm = SimpleNamespace(du_tables=DU_TABLES, mat_id=jnp.asarray(mat))
    tm = SimpleNamespace(du_tables=DU_TABLES, mat_id=torch.from_numpy(mat))
    f_ref, d_ref = jer.erosion_delete_mask(jm, jnp.asarray(eq),
                                           jnp.asarray(tri),
                                           jnp.asarray(flag))
    f_got, d_got = ter.erosion_delete_mask(tm, torch.from_numpy(eq),
                                           torch.from_numpy(tri),
                                           torch.from_numpy(flag))
    np.testing.assert_array_equal(f_got.numpy(), np.asarray(f_ref))
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(d_ref))
    d = d_got.numpy()
    assert 50 < d.sum() < 0.9 * flag.sum()            # both outcomes occur
    assert not d[~flag].any() and not d[mat == 1].any()
    t_e = tri.astype(np.float64).mean(axis=0)
    assert not d[t_e < 0].any()                        # negative triax
    assert d[(tri[0] == 0.3) & (mat == 0)].any()       # on-knot elements


def test_erode_zeroes_dead_state():
    eq, tri, flag, mat = _inputs(np.float64, E=512, seed=3)
    rng = np.random.default_rng(4)
    stress, strain = rng.normal(size=(6, 8, 512)), rng.normal(size=(6, 512))
    jm = SimpleNamespace(du_tables=DU_TABLES, mat_id=jnp.asarray(mat))
    tm = SimpleNamespace(du_tables=DU_TABLES, mat_id=torch.from_numpy(mat))
    ref = jer.erode(jm, jnp.asarray(stress), jnp.asarray(strain),
                    jnp.asarray(eq), jnp.asarray(tri), jnp.asarray(flag))
    got = ter.erode(tm, *(torch.from_numpy(x) for x in
                          (stress, strain, eq, tri, flag)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not got.stress[..., ~got.element_flag].any()

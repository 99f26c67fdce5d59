"""The streaming kernel's plain version and the port's bandwidth probe
(``hakai_tpu_torch.probes.dma``) on the CPU.  The JAX probe it replaces,
``benchmarks/dma_microbench.py``, runs its Pallas kernel at import, in
TPU memory, with no interpret mode: its arithmetic (``copy_kernel``:
``o = x + 1.0`` in float32) is restated here in NumPy.  The kernel itself
runs on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from hakai_tpu_torch.ops.stream_cuda import (LAYOUTS, layout_shape,
                                             stream_add1, stream_add1_plain)
from hakai_tpu_torch.probes import dma

E, TE = 4096, 2048


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_matches_copy_kernel_arithmetic(layout):
    """On CPU tensors the wrapper runs the plain version: x + 1.0 in
    float32, bit for bit NumPy's, into ``out`` when one is given."""
    shape = layout_shape(layout, E, TE)
    x = np.random.default_rng(3).normal(scale=1e3, size=shape) \
        .astype(np.float32)
    ref = x + np.float32(1.0)
    got = stream_add1(torch.from_numpy(x), layout, TE=TE)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    out = torch.empty(shape, dtype=torch.float32)
    assert stream_add1(torch.from_numpy(x), layout, out=out, TE=TE) is out
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(stream_add1_plain(torch.from_numpy(x))
                                  .numpy(), ref)


def test_layout_shapes():
    """The three layouts hold the same 72 x E values: strided (72, E),
    tilemajor (E/TE, 72, TE), flat (72 E/TE, TE); the tiled ones need E to
    be a multiple of TE, and unknown layouts are refused."""
    assert layout_shape("strided", E, TE) == (72, E)
    assert layout_shape("tilemajor", E, TE) == (2, 72, TE)
    assert layout_shape("flat", E, TE) == (144, TE)
    assert layout_shape("strided", 5000, TE) == (72, 5000)
    with pytest.raises(ValueError, match="multiple of TE"):
        layout_shape("flat", 5000, TE)
    with pytest.raises(ValueError, match="unknown layout"):
        stream_add1(torch.zeros(72, 8), "diagonal")


def test_probe_on_cpu(capsys):
    """``python -m hakai_tpu_torch.probes.dma --E 4096 --device cpu``: a
    line per layout, the torch.add yardstick and the bound, each with
    us/pass and GB/s; every chain of n passes from zeros ends at float(n)
    exactly (the probe raises otherwise)."""
    res = dma.main(["--E", str(E), "--TE", str(TE), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("dma probe on cpu: (72, 4096) float32")
    keys = sorted(LAYOUTS) + ["torch.add", "bound"]
    assert sorted(res) == sorted(keys)
    for line in out[1:]:
        assert line.split()[0] in keys and "us/pass" in line \
            and "GB/s (r+w)" in line
    assert all(v > 0 for v in res.values())
    assert res["bound"] == pytest.approx(2 * 72 * E * 4 / 3.35e12)


def test_probe_checks_the_chain():
    """The chain of passes ping-pongs two buffers from zeros; a step that
    does not add 1.0 is caught."""
    r, _ = dma.chain(lambda a, b: stream_add1(a, "strided", out=b, TE=TE),
                     (72, E), 7, torch.device("cpu"))
    assert bool((r == 7.0).all())
    with pytest.raises(AssertionError, match="did not give"):
        dma.slope(lambda a, b: b.copy_(a + 2.0), (72, 8), 1, 2,
                  torch.device("cpu"))
    with pytest.raises(ValueError, match="n1 < n2"):
        dma.probe(E, TE, 5, 5, "cpu")

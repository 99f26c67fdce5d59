"""The interleave kernel's plain version and the port's interleave probe
(``hakai_tpu_torch.probes.interleave``) on the CPU.  The JAX probe it
replaces, ``benchmarks/interleave_microbench.py``, runs its Pallas kernel
at import, in TPU memory, with no interpret mode: its arithmetic
(``kernel``, :33-58) is restated here in NumPy, tile by tile, and the
one XLA operation whose meaning is not plain from the source, the
``gatherrow`` mode's batched ``lax.gather``, is run through JAX on the
CPU.  The kernel itself runs on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from hakai_tpu_torch.ops.interleave_cuda import (MODES, OFFSETS,
                                                 builds_plain, interleave,
                                                 interleave_plain,
                                                 window_place, window_slabs)
from hakai_tpu_torch.probes import interleave as probe

W, LANE = 64, 128


def numpy_kernel(src, off, mode, n_tiles, builds):
    """``kernel`` of benchmarks/interleave_microbench.py:33-58 in NumPy:
    per tile, acc = 0 then acc = acc + v for each build, in float32."""
    out = np.zeros((n_tiles * 8, LANE), np.float32)
    row_i = np.broadcast_to(np.arange(8)[:, None], (8, LANE))
    for t in range(n_tiles):
        acc = np.zeros((8, LANE), np.float32)
        for b in range(builds):
            if mode == "copy":
                v = src[b % W]
            elif mode == "stackrows":
                v = np.stack([src[off[i] + (b % 16), i % 8, :]
                              for i in range(8)])
            elif mode == "selrows":
                v = np.zeros((8, LANE), np.float32)
                for i in range(8):
                    r = src[off[i] + (b % 16), i % 8, :]
                    v = np.where(row_i == i,
                                 np.broadcast_to(r[None], (8, LANE)), v)
            else:
                lane = (row_i * 7 + b) % LANE
                v = np.take_along_axis(src[b % W], lane, axis=1)
            acc = acc + v
        out[8 * t:8 * t + 8] = acc
    return out


def _window(seed=5):
    return np.random.default_rng(seed).normal(
        scale=100.0, size=(W, 8, LANE)).astype(np.float32)


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_matches_kernel_arithmetic(mode):
    """On CPU tensors the wrapper runs the plain version: bit for bit the
    NumPy restatement, at the probe's 60 builds and at 70 (past the
    window's 64 slabs), with the probe's offsets and with others, into
    ``out`` when one is given."""
    src = _window()
    for builds, off in ((60, OFFSETS), (70, (5, 0, 7, 1, 2, 9, 3, 0))):
        ref = numpy_kernel(src, off, mode, 3, builds)
        got = interleave(torch.from_numpy(src), mode, 3, builds, off)
        assert got.dtype == torch.float32 and got.shape == (24, LANE)
        np.testing.assert_array_equal(got.numpy(), ref)
        out = torch.empty((24, LANE))
        assert interleave(torch.from_numpy(src), mode, 3, builds, off,
                          out=out) is out
        np.testing.assert_array_equal(out.numpy(), ref)
        np.testing.assert_array_equal(
            interleave_plain(torch.from_numpy(src), mode, 3, builds, off)
            .numpy(), ref)


def test_gatherrow_is_the_batched_lax_gather():
    """The gatherrow build is XLA's gather with the TPU kernel's dimension
    numbers (:49-55): row i of window slab b % 64 read at lane (7 i + b) %
    128, the one value broadcast along the row."""
    import jax
    src = _window(7)
    row_i = np.broadcast_to(np.arange(8)[:, None], (8, LANE))
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(), collapsed_slice_dims=(1,), start_index_map=(1,),
        operand_batching_dims=(0,), start_indices_batching_dims=(0,))
    v = builds_plain(torch.from_numpy(src), "gatherrow", 70).numpy()
    for b in (0, 5, 63, 64, 69):
        lane = (row_i * 7 + b) % LANE
        ref = jax.lax.gather(src[b % W], lane[..., None].astype(np.int32),
                             dn, slice_sizes=(1, 1))
        np.testing.assert_array_equal(v[b], np.asarray(ref))
        assert (v[b] == v[b][:, :1]).all()


def test_window_slabs_and_refusals():
    """What each mode reads of the window (the kernel keeps at most 56
    slabs in shared memory and, for copy and gatherrow, the next 8 in
    registers), and the calls the wrapper refuses: an unknown mode, offsets
    that are not eight non-negative ints, a build past the window."""
    assert window_slabs("copy", W, 60) == 60
    assert window_slabs("gatherrow", W, 70) == 64
    assert window_slabs("stackrows", W, 60) == 19
    assert window_slabs("selrows", W, 8) == 11
    assert window_place("stackrows", W, 60) == "slabs 0-18 in shared memory"
    assert window_place("copy", W, 60) == ("slabs 0-55 in shared memory, "
                                           "56-59 in registers")
    assert window_place("gatherrow", W, 70) == (
        "slabs 0-55 in shared memory, 56-63 in registers (on the first "
        "pass; later passes through L1/L2)")
    assert window_place("copy", 100, 100) == (
        "slabs 0-55 in shared memory, 56-63 in registers, 64-99 through "
        "L1/L2")
    src = torch.zeros((W, 8, LANE))
    with pytest.raises(ValueError, match="unknown mode"):
        interleave(src, "diagonal", 1, 4)
    with pytest.raises(ValueError, match="8 non-negative"):
        interleave(src, "copy", 1, 4, (0, 1, 2))
    with pytest.raises(ValueError, match="8 non-negative"):
        interleave(src, "copy", 1, 4, (0, -1, 2, 3, 0, 1, 2, 3))
    with pytest.raises(ValueError, match="reads slab 64 of a 64-slab"):
        interleave(src, "stackrows", 1, 60, (49, 0, 0, 0, 0, 0, 0, 0))


def test_probe_on_cpu(capsys):
    """``python -m hakai_tpu_torch.probes.interleave --device cpu``: a
    header and a line per mode, in the TPU probe's order, with us/pass and
    ns/build; each mode's chain of n2 passes is its plain version's (the
    probe raises otherwise)."""
    res = probe.main(["--tiles", "4", "--builds", "20", "--n1", "1",
                      "--n2", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("interleave probe on cpu: 4 tiles x 20 builds")
    assert [x.split()[0] for x in out[1:]] == ["copy", "selrows",
                                               "stackrows", "gatherrow"]
    for line in out[1:]:
        assert "us/pass" in line and "ns/build" in line \
            and "bitwise its plain version's" in line
    assert sorted(res) == sorted(MODES)
    b_s, by = probe.bound_s("copy", 512, 60)
    assert by == "bytes"
    assert b_s == pytest.approx((60 * 4096 + 512 * 4096) / 3.35e12)
    with pytest.raises(ValueError, match="n1 < n2"):
        probe.probe(4, 20, 3, 3, "cpu")


def test_probe_checks_the_chain(monkeypatch):
    """A pass chains on the last one's output (the TPU probe's loop2), and
    a kernel whose chain parts from the plain version's is caught."""
    src = torch.from_numpy(_window(9))
    s, out = probe.chain(lambda x: interleave(x, "copy", 2, 5), src, 3)
    ref_s = src
    for _ in range(3):
        ref = interleave_plain(ref_s, "copy", 2, 5)
        ref_s = ref_s + 1e-30 * ref[:1, :1]
    assert torch.equal(out, ref) and torch.equal(s, ref_s)

    def off_by_one(x, mode, tiles, builds, out=None):
        return out.copy_(interleave_plain(x, mode, tiles, builds) + 1.0)
    monkeypatch.setattr(probe, "interleave", off_by_one)
    with pytest.raises(AssertionError, match="differs from its plain"):
        probe.probe(2, 4, 1, 2, "cpu", out=lambda *a: None)

"""``python -m hakai_tpu_torch deck.inp`` against ``python -m hakai_tpu
deck.inp`` on the CPU, on decks written as real ``.inp`` text by
``scripts/inp_deck.py``: a ductile tensile bar with ``*Amplitude``,
``*Boundary`` and ``*Damage Initiation`` (256 elements), and the
two-instance ``*Contact Pair`` deck of tests/test_oracle_diff.py.  Both
CLIs run in this process (the port's with ``--device cpu``, the JAX
package's with ``--compile-cache off``)."""
import dataclasses
import os
import re
import sys
from contextlib import redirect_stdout
from io import StringIO

import numpy as np
import pytest
import torch

from hakai_tpu import cli as jcli
from hakai_tpu.config import SolverConfig as JConfig
from hakai_tpu.core.lowering import lower as jax_lower
from hakai_tpu.core.state import init_state as jax_init_state
from hakai_tpu.io.inp import read_inp_file as jax_read_inp_file
from hakai_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from hakai_tpu_torch import SolverConfig, cli as tcli, init_state, lower
from hakai_tpu_torch import parse_inp_lines, read_inp_file
from hakai_tpu_torch.pre import synthetic as tsyn
from hakai_tpu_torch.utils.checkpoint import load_checkpoint
from test_torch_run import _sections

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from inp_deck import cp_deck_lines, deck_text  # noqa: E402

DECKS = {
    # first deletions near step 130 of 800
    "ductile": lambda: deck_text(tsyn.bar_model(
        4, 4, 16, d_time=5e-8, end_time=4e-5, ductile=True)),
    "contact_pair": lambda: "\n".join(cp_deck_lines()) + "\n",
}
FLAGS = ["--precision", "f64", "--output-num", "10", "--checkpoint-every",
         "5"]
# a progress tick of run(): "\r1.2000e-05 / 4.0000e-05     "
_TICK = re.compile(r"^\d\.\d{4}e[-+]\d\d / \d\.\d{4}e[-+]\d\d\s*")


def console(text):
    """The console lines that carry results: the run's progress ticks (a
    line printed after one follows it on the same line) and its wall-clock
    line are left out."""
    lines = [_TICK.sub("", x) for x in re.split(r"[\r\n]", text)]
    return [x for x in lines if x.strip() and not x.startswith("wall:")]


@pytest.fixture(scope="module", params=sorted(DECKS))
def runs(request, tmp_path_factory):
    """Each CLI once on the deck, each into a directory of its own, with
    its console output."""
    d = tmp_path_factory.mktemp(request.param)
    deck = d / "deck.inp"
    deck.write_text(DECKS[request.param]())
    out = {"deck": deck, "name": request.param}
    for pkg, main, extra in (("jax", jcli.main, ["--compile-cache", "off"]),
                             ("port", tcli.main, ["--device", "cpu"])):
        buf = StringIO()
        with redirect_stdout(buf):
            state = main([str(deck), "--out-dir", str(d / pkg)] + FLAGS
                         + extra)
        out[pkg] = (d / pkg, buf.getvalue(), state)
    return out


def test_console_lines_equal(runs):
    """The header lines (nNode, nElement, contact_flag, mass_scaling,
    time_num, elementMinSize, elementMaxSize), the f64 contact hint and
    every "Element deleted" line, in the same order."""
    ref, got = console(runs["jax"][1]), console(runs["port"][1])
    assert ref == got
    assert got[0].startswith("nNode:") and got[4].startswith("time_num:")
    if runs["name"] == "ductile":
        assert got[4] == "time_num:800"
        assert any(x.startswith("Element deleted:") for x in got)
    else:
        assert got[1] == "nElement:20" and got[2] == "contact_flag:1"
        assert got[7].startswith("hint: this contact deck")


def test_frames_match(runs):
    """The same frame files and collection.pvd bytes; per frame the same
    section headers, connectivity and cell types (deleted elements left
    out alike), and every float field within 1e-6 of its largest
    magnitude (one unit in the last printed digit; both runs are f64)."""
    jdir, tdir = runs["jax"][0], runs["port"][0]
    names = sorted(p.name for p in jdir.glob("file*.vtk"))
    assert len(names) == 11
    assert names == sorted(p.name for p in tdir.glob("file*.vtk"))
    assert ((jdir / "collection.pvd").read_bytes()
            == (tdir / "collection.pvd").read_bytes())
    for name in names:
        ref = _sections((jdir / name).read_text())
        got = _sections((tdir / name).read_text())
        assert [h for h, _ in got] == [h for h, _ in ref], name
        for (head, a), (_, b) in zip(ref, got):
            assert len(a) == len(b), (name, head)
            if head.startswith(("CELLS", "CELL_TYPES")):
                assert a == b, (name, head)
            elif a:
                fa = np.array([x.split() for x in a], np.float64)
                fb = np.array([x.split() for x in b], np.float64)
                scale = max(np.abs(fa).max(), 1e-300)
                assert np.abs(fa - fb).max() <= 1e-6 * scale, (name, head)


def test_final_checkpoints_cross_load(runs):
    """final.ckpt.npz of each CLI loads in the other package, with equal
    step counts and flags and the state within 1e-9 of each field's
    scale."""
    deck = str(runs["deck"])
    jm = jax_lower(jax_read_inp_file(deck), JConfig(dtype="float64"))
    tm = lower(read_inp_file(deck), SolverConfig(dtype="float64"),
               device="cpu")
    js = jax_load_checkpoint(str(runs["port"][0] / "final.ckpt.npz"),
                             jax_init_state(jm))
    ts = load_checkpoint(str(runs["jax"][0] / "final.ckpt.npz"),
                         init_state(tm))
    assert int(js.t) == int(ts.t) == tm.time_num
    np.testing.assert_array_equal(np.asarray(js.element_flag),
                                  ts.element_flag.numpy())
    for name in ("disp", "velo", "stress", "eq_ps"):
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert np.abs(a - b).max() <= 1e-9 * max(np.abs(b).max(), 1e-300)


def test_resume_continues(runs, tmp_path, capsys):
    """``--resume ckpt_005.npz`` continues the port's run from frame 5:
    it prints the step it resumes at and ends in the uninterrupted run's
    final state, bitwise."""
    tdir = runs["port"][0]
    tcli.main([str(runs["deck"]), "--out-dir", str(tmp_path), "--resume",
               str(tdir / "ckpt_005.npz"), "--device", "cpu"] + FLAGS)
    out = capsys.readouterr().out
    assert re.search(r"^resumed at step \d+$", out, re.M)
    a, b = (np.load(p / "final.ckpt.npz") for p in (tdir, tmp_path))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["ductile", "bar_renumbered", "impact",
                                  "self_contact", "contact_pair"])
@pytest.mark.parametrize("dtype", ["float64", "mixed"])
def test_parsed_deck_lowers_equal(name, dtype):
    """``lower(parse(deck_text(m)))`` equals ``lower(m)`` field by field in
    the port (the card's CLI check runs a written deck against the model
    it was written from); the contact-pair deck, which has no model
    builder, against the JAX package's parse of the same text."""
    builders = {
        "ductile": lambda: tsyn.bar_model(4, 4, 16, d_time=5e-8,
                                          end_time=4e-5, ductile=True),
        "bar_renumbered": lambda: tsyn.bar_model(8, 8, 32, ductile=True),
        "impact": lambda: tsyn.impact_model(n=3),
        "self_contact": lambda: tsyn.self_contact_model()}
    cfg = SolverConfig(dtype=dtype)
    if name == "contact_pair":
        from hakai_tpu.io.inp import parse_inp_lines as jparse
        from test_torch_copies import assert_same
        lines = cp_deck_lines()
        got = parse_inp_lines(lines)
        assert_same(jparse(lines), got)
        ref = lower(got, cfg, device="cpu")
        assert len(ref.pairs) == 2
    else:
        m = builders[name]()
        ref = lower(m, cfg, device="cpu")
        got = lower(parse_inp_lines(deck_text(m).splitlines()), cfg,
                    device="cpu")
        _same_model(ref, got)
    assert (ref.node_new2old is not None) == (name == "bar_renumbered")


def _same_model(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        elif f.name == "pairs":
            assert len(x) == len(y)
            for p, q in zip(x, y):
                _same_model(p, q)
        else:
            assert x == y, f.name


def test_pallas_f64_refused_by_both(tmp_path, capsys):
    """``--element-kernel pallas`` with ``--precision f64``: both CLIs stop
    with the same usage error."""
    deck = tmp_path / "deck.inp"
    deck.write_text(DECKS["ductile"]())
    msgs = []
    for main, extra in ((jcli.main, ["--compile-cache", "off"]),
                        (tcli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as err:
            main([str(deck), "--element-kernel", "pallas", "--precision",
                  "f64", "--out-dir", str(tmp_path)] + extra)
        assert err.value.code == 2
        msgs.append(capsys.readouterr().err.splitlines()[-1].split(": ", 1))
    assert msgs[0][1] == msgs[1][1]


def test_devices_not_ported(tmp_path):
    """``--multihost`` runs (multi-host runs are ported: more in
    tests/test_torch_multihost.py): as process 0 of a one-process run, in
    a fresh interpreter, the CLI hosts the rendezvous, runs the deck and
    writes the frames and final checkpoint of the plain run; a malformed
    spec stops; and ``--resume`` of a shard-major halo checkpoint without
    ``--halo`` stops, as the JAX CLI does."""
    import socket
    import subprocess
    from hakai_tpu_torch.parallel import halo as thalo
    deck = tmp_path / "deck.inp"
    deck.write_text(DECKS["ductile"]())
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = {}
    for name, extra in (("plain", []), ("multihost", [
            "--multihost", f"127.0.0.1:{port},1,0"])):
        r = subprocess.run(
            [sys.executable, "-m", "hakai_tpu_torch", str(deck), "--device",
             "cpu", "--output-num", "2", "--checkpoint-every", "2",
             "--out-dir", str(tmp_path / name)] + extra,
            cwd=root, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        outs[name] = console(r.stdout)
    assert outs["plain"] == outs["multihost"]
    for f in ("file002.vtk", "final.ckpt.npz"):
        assert (tmp_path / "plain" / f).read_bytes() == \
            (tmp_path / "multihost" / f).read_bytes(), f
    with pytest.raises(SystemExit, match="ADDR:PORT,NPROC,PID"):
        tcli.main([str(deck), "--device", "cpu", "--no-output",
                   "--out-dir", str(tmp_path), "--multihost", "127.0.0.1"])
    m = lower(read_inp_file(str(deck)), SolverConfig(node_pad=16,
                                                     renumber="always"),
              device="cpu")
    hm = thalo.partition(m, 2)
    ckpt = str(tmp_path / "halo.npz")
    thalo.save_halo_checkpoint(ckpt, hm, thalo.init_halo_state(hm))
    with pytest.raises(SystemExit, match="pass the matching --halo N"):
        tcli.main([str(deck), "--device", "cpu", "--no-output",
                   "--out-dir", str(tmp_path), "--resume", ckpt])


def test_devices_frames_match(tmp_path):
    """``--devices 2 --device cpu --dist-backend gloo`` on the 256-element
    ductile deck writes the frames of the single-device ``--devices 1``
    run, byte for byte, and returns the same final state."""
    deck = tmp_path / "deck.inp"
    deck.write_text(DECKS["ductile"]())
    states, dirs = {}, {}
    for n, extra in (("1", []), ("2", ["--dist-backend", "gloo"])):
        dirs[n] = tmp_path / f"dev{n}"
        with redirect_stdout(StringIO()):
            states[n] = tcli.main(
                [str(deck), "--device", "cpu", "--out-dir", str(dirs[n]),
                 "--precision", "f64", "--output-num", "4", "--devices", n]
                + extra)
    names = sorted(p.name for p in dirs["1"].glob("*.vtk"))
    assert len(names) == 5
    for name in names:
        assert (dirs["1"] / name).read_bytes() == \
            (dirs["2"] / name).read_bytes(), name
    assert int(states["2"].element_flag.sum()) < 256
    assert torch.equal(states["1"].disp, states["2"].disp)


def test_profile_writes_chrome_trace(tmp_path, capsys):
    """``--profile DIR`` writes a torch.profiler Chrome trace of the run
    (ten steps of a small bar, no frames)."""
    import json
    deck = tmp_path / "deck.inp"
    deck.write_text(deck_text(tsyn.bar_model(2, 2, 4, d_time=5e-8,
                                             end_time=5e-7)))
    tcli.main([str(deck), "--device", "cpu", "--no-output", "--profile",
               str(tmp_path / "prof"), "--timings"])
    out = capsys.readouterr().out
    assert "time_num:10" in out and re.search(r"^timings: parse ", out, re.M)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert len(events["traceEvents"]) > 10


def test_timings_name_the_host_io_helper(tmp_path, capsys):
    """``--timings`` prints, on a line of its own, the host-IO helper's
    library that parsed the deck and wrote the frames."""
    from hakai_tpu_torch import _build
    deck = tmp_path / "deck.inp"
    deck.write_text(deck_text(tsyn.bar_model(2, 2, 4, d_time=5e-8,
                                             end_time=5e-7)))
    tcli.main([str(deck), "--device", "cpu", "--output-num", "2",
               "--out-dir", str(tmp_path / "out"), "--timings"])
    out = capsys.readouterr().out
    line = re.search(r"^host-io: C\+\+ helper (\S+)$", out, re.M)
    assert line and line.group(1) == _build.HOST_INFO["path"]
    assert os.path.basename(line.group(1)).startswith("libhakai_host_")
    assert os.path.exists(line.group(1))
    assert (tmp_path / "out" / "file002.vtk").exists()


def _trace_names(path):
    import json
    events = json.loads(path.read_text())["traceEvents"]
    return {e.get("name", "") for e in events}


def _rank_trace_ok(names):
    """A rank's step ops (the element kernel's plain einsums, the
    assembly's masked sums) and its collective (gloo's all-gather, or the
    c10d record op) in one trace."""
    coll = [n for n in names if "all_gather" in n.lower()
            or "allgather" in n.lower() or n == "record_param_comms"]
    return "aten::einsum" in names and "aten::sum" in names and coll


def test_devices_profile_traces_rank0(tmp_path):
    """``--devices 2 --profile DIR``: rank 0 traces its own loop, so the
    trace holds its step ops and its all-gathers (the parent, which only
    spawns and waits, traces nothing)."""
    deck = tmp_path / "deck.inp"
    deck.write_text(DECKS["ductile"]())
    with redirect_stdout(StringIO()):
        tcli.main([str(deck), "--device", "cpu", "--no-output", "--devices",
                   "2", "--profile", str(tmp_path / "prof")])
    assert _rank_trace_ok(_trace_names(tmp_path / "prof" / "trace.json"))


def test_halo_frames_match(tmp_path, capfd):
    """``--halo 2 --device cpu --dist-backend gloo --profile DIR`` on the
    256-element ductile deck: the frames of the single-device run within
    1e-6 of each field's largest magnitude (a halo Q sums the ghost rows in
    another order; both runs f64), the same deletion lines, the final
    shard-major checkpoints resumable with ``--halo 2``, and rank 0's
    trace with its step ops and its collective.  The console is read at
    the file descriptor: rank 0, a spawned process, prints the deletion
    lines."""
    deck = tmp_path / "deck.inp"
    deck.write_text(DECKS["ductile"]())
    outs, dirs = {}, {}
    for name, extra in (("one", []), ("halo", [
            "--halo", "2", "--dist-backend", "gloo", "--checkpoint-every",
            "2", "--profile", str(tmp_path / "prof")])):
        dirs[name] = tmp_path / name
        tcli.main([str(deck), "--device", "cpu", "--out-dir",
                   str(dirs[name]), "--precision", "f64", "--output-num",
                   "4"] + extra)
        outs[name] = console(capfd.readouterr().out)
    assert outs["one"] == outs["halo"]
    assert any(x.startswith("Element deleted:") for x in outs["halo"])
    names = sorted(p.name for p in dirs["one"].glob("*.vtk"))
    assert len(names) == 5
    assert names == sorted(p.name for p in dirs["halo"].glob("*.vtk"))
    for name in names:
        ref = _sections((dirs["one"] / name).read_text())
        got = _sections((dirs["halo"] / name).read_text())
        assert [h for h, _ in got] == [h for h, _ in ref], name
        for (head, a), (_, b) in zip(ref, got):
            if head.startswith(("CELLS", "CELL_TYPES")):
                assert a == b, (name, head)
            elif a:
                fa = np.array([x.split() for x in a], np.float64)
                fb = np.array([x.split() for x in b], np.float64)
                scale = max(np.abs(fa).max(), 1e-300)
                assert np.abs(fa - fb).max() <= 1e-6 * scale, (name, head)
    assert _rank_trace_ok(_trace_names(tmp_path / "prof" / "trace.json"))
    final = tcli.main([str(deck), "--device", "cpu", "--no-output",
                       "--out-dir", str(tmp_path / "resumed"), "--halo", "2",
                       "--precision", "f64", "--resume",
                       str(dirs["halo"] / "ckpt_002.npz")])
    assert "resuming from halo checkpoint" in capfd.readouterr().out
    assert int(final.t) == 800

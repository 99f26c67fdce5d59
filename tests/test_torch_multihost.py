"""Multi-process runs of the port (``hakai_tpu_torch.parallel.dist.
initialize``, the CLI's ``--multihost``) on the CPU, against the port's
one-process runs and the JAX package at tests/test_multihost.py's
tolerances.

Children are subprocess scripts, as in tests/test_multihost.py: two port
processes of two gloo ranks each (``run(halo=4)``: global ranks 0-1 in
process 0, 2-3 in process 1), started together while this process runs
the JAX references; then one port process of four ranks, beside two JAX
processes of two CPU devices each that load the port's per-process
checkpoint files and write them again with JAX's own writer.  Every child
is waited on with a timeout, so a hung store fails its test."""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from hakai_tpu import cli as jcli
from hakai_tpu_torch import SolverConfig, cli as tcli, lower
from hakai_tpu_torch.parallel import dist as tdist
from hakai_tpu_torch.parallel import halo as thalo
from hakai_tpu_torch.pre import synthetic as tsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from inp_deck import deck_text  # noqa: E402

TIMEOUT = 600
BAR_STEPS, IMPACT_STEPS = 60, 40

# the decks of tests/test_multihost.py, built by either package's
# synthetic module, and the port's SolverConfig keywords of each
DECKS = textwrap.dedent("""
    import dataclasses
    import numpy as np


    def bar(syn):
        return syn.bar_model(nx=4, ny=4, nz=32, d_time=1e-7)


    def impact(syn):
        # the cube moved off the slab's grid lines: on aligned grids the
        # accept tests tie, and the two packages break ties apart
        from hakai_tpu_torch.pre.synthetic import offset_instance
        return offset_instance(syn.impact_model(n=2, v0=5.0e4, d_time=4e-8),
                               1, 0.013, 0.017)


    def eroding(syn):
        m = syn.impact_model(n=2, v0=8.0e4, d_time=4e-8, end_time=1.2e-5)
        m.materials[0].ductile = np.array([[0.02, 0.0, 30.0],
                                           [0.01, 0.3, 30.0]])
        return m


    CFG = {"bar": dict(dtype="float64", node_pad=64, renumber="always"),
           "impact": dict(dtype="float64", node_pad=64, elem_pad=8,
                          renumber="always"),
           "eroding": dict(dtype="float64", node_pad=64, elem_pad=8,
                           renumber="always", output_num=10)}


    def cut(m, steps):
        return dataclasses.replace(m, time_num=steps,
                                   end_time=steps * m.dt)
""")

_CHILD = textwrap.dedent("""
    import dataclasses, os, sys
    sys.path.insert(0, {repo!r})
    {decks}

    def main():
        who, port, out = sys.argv[1], sys.argv[2], sys.argv[3]
        import torch
        from hakai_tpu_torch import SolverConfig, lower, run
        from hakai_tpu_torch.parallel import dist
        from hakai_tpu_torch.pre import synthetic as syn
        if who != "one":
            dist.initialize("127.0.0.1:" + port, 2, int(who))
            assert dist.process_count() == 2
        d = os.path.join(out, "one" if who == "one" else "mp")
        res = {{}}
        bar_ = cut(lower(bar(syn), SolverConfig(
            output_num=2, checkpoint_every=1, out_dir=d + "/bar",
            **CFG["bar"]), device="cpu"), {bar})
        res["bar"] = run(bar_, verbose=False, halo=4, device="cpu")
        res["resumed"] = run(bar_, verbose=False, write_output=False,
                             halo=4, device="cpu",
                             resume_halo=d + "/bar/ckpt_001.npz")
        im = cut(lower(impact(syn), SolverConfig(output_num=1,
                                                 **CFG["impact"]),
                       device="cpu"), {impact})
        res["impact"] = run(im, verbose=False, write_output=False, halo=4,
                            device="cpu")
        er = lower(eroding(syn), SolverConfig(out_dir=d + "/eroding",
                                              **CFG["eroding"]),
                   device="cpu")
        res["eroding"] = run(er, verbose=False, halo=4, device="cpu")
        torch.save(res, os.path.join(out, who + ".pt"))

    if __name__ == "__main__":
        main()
""").format(repo=REPO, decks=DECKS, bar=BAR_STEPS, impact=IMPACT_STEPS)

# JAX's multi-process loader and writer on the port's per-process files:
# 2 processes x 2 CPU devices, the 4-shard bar of the port's run
_JAX_CHILD = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                               num_processes=2, process_id=pid)
    {decks}
    from hakai_tpu.config import SolverConfig
    from hakai_tpu.core.lowering import lower
    from hakai_tpu.parallel.halo import (load_halo_checkpoint, partition,
                                         save_halo_checkpoint)
    from hakai_tpu.parallel.sharding import make_mesh
    from hakai_tpu.pre import synthetic as syn

    hm = partition(lower(bar(syn), SolverConfig(**CFG["bar"])), 4)
    mesh = make_mesh(4)
    s = load_halo_checkpoint(os.path.join(out, "mp/bar/ckpt_001.npz"), hm,
                             mesh=mesh)
    save_halo_checkpoint(os.path.join(out, "jax_ckpt.npz"), hm, s, mesh=mesh)
    jax.distributed.shutdown()
""").format(repo=REPO, decks=DECKS)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(cmds, cwd, env=None):
    """Start every command at once; their (returncode, output), each waited
    on for TIMEOUT seconds at most."""
    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _decks():
    ns = {}
    exec(DECKS, ns)
    return ns


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's two-process runs and one-process runs of every deck, the
    JAX references, and JAX's rewrite of the port's per-process files."""
    from hakai_tpu.config import SolverConfig as JConfig
    from hakai_tpu.core.lowering import lower as jax_lower
    from hakai_tpu.core.state import init_state as jax_init_state
    from hakai_tpu.pre import synthetic as jsyn
    from hakai_tpu.solver.explicit import run as jax_run
    from hakai_tpu.solver.explicit import run_chunk as jax_run_chunk
    tmp = tmp_path_factory.mktemp("multihost")
    script = tmp / "child.py"
    script.write_text(_CHILD)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), who, port, str(tmp)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for who in ("0", "1")]
    try:
        ns = _decks()
        jax = {}
        for name, steps in (("bar", BAR_STEPS), ("impact", IMPACT_STEPS)):
            jm = jax_lower(ns[name](jsyn), JConfig(**ns["CFG"][name]))
            jax[name] = jax_run_chunk(jm, jax_init_state(jm), steps)
        jm = jax_lower(ns["eroding"](jsyn), JConfig(
            out_dir=str(tmp / "jax_eroding"), **ns["CFG"]["eroding"]))
        jax["eroding"] = jax_run(jm, verbose=False, write_output=True)
        outs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    # then the one-process runs beside JAX's two processes: fewer
    # processes at once on a loaded host
    jax_script = tmp / "jax_child.py"
    jax_script.write_text(_JAX_CHILD)
    jax_port = str(_free_port())
    for rc, o in _spawn([[sys.executable, str(script), "one", port, str(tmp)]]
                        + [[sys.executable, str(jax_script), pid, jax_port,
                            str(tmp)] for pid in ("0", "1")], REPO, env):
        assert rc == 0, o[-4000:]
    res = {who: torch.load(tmp / f"{who}.pt", weights_only=False)
           for who in ("0", "1", "one")}
    return dict(tmp=tmp, res=res, jax=jax, ns=ns)


def _equal(a, b) -> list:
    """The fields of two states that are not bitwise equal."""
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


def test_bar_and_impact_match_jax_and_one_process(runs):
    """Two processes of two gloo ranks each, run(halo=4): both processes
    return the one-process run(halo=4)'s final state bit for bit, and the
    bar (60 steps) and the impact (40 steps) hold tests/test_multihost.py's
    tolerances against JAX's single-process run_chunk."""
    res, jax = runs["res"], runs["jax"]
    for name in ("bar", "impact", "eroding"):
        for who in ("0", "1"):
            assert _equal(res[who][name], res["one"][name]) == [], \
                (name, who)
    bar, ref = res["0"]["bar"], jax["bar"]
    assert int(bar.t) == BAR_STEPS
    np.testing.assert_allclose(bar.disp.numpy(), np.asarray(ref.disp),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(bar.stress.numpy(), np.asarray(ref.stress),
                               rtol=1e-7, atol=1e-9)
    assert float(np.abs(bar.eq_ps.numpy() - np.asarray(ref.eq_ps)).max()) \
        < 1e-3
    assert float(bar.disp.abs().max()) > 0
    imp, ref = res["0"]["impact"], jax["impact"]
    assert int(imp.t) == IMPACT_STEPS
    np.testing.assert_allclose(imp.disp.numpy(), np.asarray(ref.disp),
                               rtol=1e-9, atol=1e-12)
    assert np.array_equal(imp.element_flag.numpy(),
                          np.asarray(ref.element_flag))
    # the premise: contact engages within the 40 steps (from step 26; a
    # halo state's gathered contact_force is zeros, as in JAX's)
    from hakai_tpu_torch import init_state, run_chunk
    m = lower(runs["ns"]["impact"](tsyn), SolverConfig(
        **runs["ns"]["CFG"]["impact"]), device="cpu")
    s, seen = init_state(m), 0.0
    for _ in range(IMPACT_STEPS):
        s = run_chunk(m, s, 1)
        seen = max(seen, float(s.contact_force.abs().max()))
    assert seen > 0


def _frame_numbers(path):
    with open(path) as f:
        return f.read().splitlines()


def test_eroding_contact_frames(runs):
    """The eroding contact deck of test_four_process_contact_erosion_vtk
    through run(halo=4) on two processes: process 0's 11 frames and
    collection.pvd are byte-identical to the one-process run's, it erodes,
    and against JAX's single-process frames every structural line is equal
    and every number within _vtk_equal's tolerances (rtol 1e-9, atol
    1e-12), save for values that round to neighbouring last printed digits
    (%1.6e: within 1e-6 of the value), of which there are a handful: the
    port's states differ from JAX's by roundoff."""
    tmp = runs["tmp"]
    mp, one, jx = (tmp / "mp" / "eroding", tmp / "one" / "eroding",
                   tmp / "jax_eroding")
    names = sorted(p.name for p in one.iterdir())
    assert names == sorted(p.name for p in mp.iterdir())
    assert len([n for n in names if n.endswith(".vtk")]) == 11
    for n in names:
        assert (mp / n).read_bytes() == (one / n).read_bytes(), n
    lm = lower(runs["ns"]["eroding"](tsyn), SolverConfig(
        **runs["ns"]["CFG"]["eroding"]), device="cpu")
    assert int(runs["res"]["0"]["eroding"].element_flag.sum()) \
        < lm.n_element
    flips = 0
    for k in range(11):
        la = _frame_numbers(mp / f"file{k:03d}.vtk")
        lb = _frame_numbers(jx / f"file{k:03d}.vtk")
        assert len(la) == len(lb), k
        for i, (x, y) in enumerate(zip(la, lb)):
            if x == y:
                continue
            try:
                vx = np.array([float(t) for t in x.split()])
                vy = np.array([float(t) for t in y.split()])
            except ValueError:
                raise AssertionError(f"frame {k} line {i + 1}: {x!r} vs "
                                     f"{y!r}")
            if np.allclose(vx, vy, rtol=1e-9, atol=1e-12):
                continue
            assert np.all(np.abs(vx - vy) <= 1e-6 * np.abs(vy)), (k, x, y)
            flips += 1
    assert flips <= 10


def test_checkpoint_files(runs):
    """run(halo=4) on two processes writes, per checkpoint, the manifest
    (halo_format, halo_manifest == [2]) and one file a process: rows [0, 1]
    and [2, 3], halo_procs [K, 2], every state leaf with a leading axis of
    2 and t whole, and, written again by JAX's multi-process writer after
    JAX's multi-process loader read them, the same keys, dtypes, shapes
    and bits."""
    d = runs["tmp"] / "mp" / "bar"
    for ck in ("ckpt_001.npz", "ckpt_002.npz"):
        with np.load(d / ck) as m:
            assert sorted(m.files) == ["halo_format", "halo_manifest"]
            assert list(m["halo_manifest"]) == [2]
            fmt = list(m["halo_format"])
        for pid, rows in ((0, [0, 1]), (1, [2, 3])):
            with np.load(d / f"{ck}.p{pid}.npz") as f:
                assert list(f["halo_rows"]) == rows
                assert list(f["halo_procs"]) == [pid, 2]
                assert list(f["halo_format"]) == fmt and fmt[0] == 4
                assert f["t"].shape == ()
                assert f["disp"].shape[0] == f["stress"].shape[0] == 2
    for pid in (0, 1):
        port = np.load(d / f"ckpt_001.npz.p{pid}.npz")
        jax = np.load(runs["tmp"] / f"jax_ckpt.npz.p{pid}.npz")
        assert sorted(port.files) == sorted(jax.files)
        for k in jax.files:
            assert port[k].dtype == jax[k].dtype, k
            assert np.array_equal(port[k], jax[k]), k
    with np.load(d / "ckpt_001.npz") as m, \
            np.load(runs["tmp"] / "jax_ckpt.npz") as j:
        assert sorted(m.files) == sorted(j.files)
        for k in j.files:
            assert np.array_equal(m[k], j[k]) and m[k].dtype == j[k].dtype


def test_checkpoint_union_and_resume(runs):
    """The two processes' rows of each checkpoint, stacked, are the
    one-process run's single file bit for bit; the run resumed from the
    first (both processes reading only their own files) ends on the
    uninterrupted run's state bit for bit."""
    mp, one = runs["tmp"] / "mp" / "bar", runs["tmp"] / "one" / "bar"
    for ck in ("ckpt_001.npz", "ckpt_002.npz"):
        ref = np.load(one / ck)
        parts = [np.load(mp / f"{ck}.p{pid}.npz") for pid in (0, 1)]
        for k in ref.files:
            got = (parts[0][k] if k in ("t", "halo_format")
                   else np.concatenate([p[k] for p in parts]))
            assert got.dtype == ref[k].dtype and np.array_equal(got, ref[k]), \
                (ck, k)
    for who in ("0", "1", "one"):
        r = runs["res"][who]
        assert int(r["resumed"].t) == BAR_STEPS
        assert _equal(r["resumed"], r["bar"]) == [], who


def test_resume_in_another_process_count_raises(runs):
    """A two-process checkpoint does not resume in one process (JAX's
    message), and a one-process file needs the same partition."""
    m = lower(runs["ns"]["bar"](tsyn), SolverConfig(
        **runs["ns"]["CFG"]["bar"]), device="cpu")
    hm = thalo.partition(m, 4)
    with pytest.raises(ValueError, match="written by 2 processes; this run "
                       "has 1"):
        thalo.load_halo_checkpoint(
            str(runs["tmp"] / "mp" / "bar" / "ckpt_001.npz"), hm)
    hs = thalo.load_halo_checkpoint(
        str(runs["tmp"] / "one" / "bar" / "ckpt_001.npz"), hm)
    assert hs.disp.shape[0] == 4 and int(hs.t) == BAR_STEPS // 2
    with pytest.raises(ValueError, match="does not match the current"):
        thalo.load_halo_checkpoint(
            str(runs["tmp"] / "one" / "bar" / "ckpt_001.npz"),
            thalo.partition(m, 2))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--halo", "--devices"])
def test_cli_multihost(tmp_path, flag):
    """``python -m hakai_tpu_torch deck.inp FLAG 4 --multihost
    127.0.0.1:P,2,K --device cpu`` in two processes, each with an output
    directory of its own: both print the deck's lines, process 0 writes
    the frames, collection.pvd, the metrics and final.ckpt.npz, byte for
    byte the one-process run's (``--halo 4``; for --devices the
    single-device run's, which a sharded run equals bitwise), and process
    1 writes nothing but, on a halo run, its own checkpoint files."""
    deck = tmp_path / "deck.inp"
    deck.write_text(deck_text(tsyn.bar_model(4, 4, 16, d_time=5e-8,
                                             end_time=1e-5, ductile=True)))
    port = str(_free_port())
    common = ["--device", "cpu", "--precision", "f64", "--output-num", "4",
              "--checkpoint-every", "2", "--dist-backend", "gloo"]

    def cmd(name, extra):
        return [sys.executable, "-m", "hakai_tpu_torch", str(deck),
                "--out-dir", str(tmp_path / name), "--metrics",
                str(tmp_path / f"{name}.jsonl")] + common + extra
    one = ["--halo", "4"] if flag == "--halo" else []
    got = _spawn([cmd("p0", [flag, "4", "--multihost",
                             f"127.0.0.1:{port},2,0"]),
                  cmd("p1", [flag, "4", "--multihost",
                             f"127.0.0.1:{port},2,1"])], REPO)
    got += _spawn([cmd("one", one)], REPO)
    for rc, o in got:
        assert rc == 0, o[-4000:]
        assert "nNode:425" in o and "time_num:200" in o
    assert any("Element deleted" in o for _, o in got[:1])
    p0, p1, ref = (tmp_path / k for k in ("p0", "p1", "one"))
    names = sorted(p.name for p in ref.iterdir())
    assert "final.ckpt.npz" in names and "collection.pvd" in names
    for n in names:
        if n.endswith((".vtk", ".pvd")):
            assert (p0 / n).read_bytes() == (ref / n).read_bytes(), n
    recs = [[{k: v for k, v in json.loads(x).items() if k != "wall_s"}
             for x in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
            for name in ("p0", "one")]
    assert recs[0] == recs[1] and len(recs[0]) == 4
    assert not (tmp_path / "p1.jsonl").exists()
    fin = np.load(p0 / "final.ckpt.npz")
    ref_fin = np.load(ref / "final.ckpt.npz")
    for k in ref_fin.files:
        assert np.array_equal(fin[k], ref_fin[k]), k
    left = sorted(p.name for p in p1.iterdir()) if p1.exists() else []
    if flag == "--halo":
        assert left == ["ckpt_002.npz.p1.npz", "ckpt_004.npz.p1.npz"]
        assert sorted(p.name for p in p0.iterdir() if "ckpt_" in p.name) \
            == ["ckpt_002.npz", "ckpt_002.npz.p0.npz", "ckpt_004.npz",
                "ckpt_004.npz.p0.npz"]
    else:
        assert left == []


def test_multihost_spec_parses_as_jax(monkeypatch):
    """``--multihost ADDR:PORT,NPROC,PID`` splits as the JAX CLI splits it
    (what it hands jax.distributed.initialize, an IPv6 address included);
    a spec without its two commas stops."""
    import jax

    class Stop(Exception):
        pass

    def grab(**kw):
        seen.append(kw)
        raise Stop
    monkeypatch.setattr(jax.distributed, "initialize", grab)
    for spec in ("10.0.0.1:1234,4,3", "[::1]:9999,2,0", "host-a:7,1,0"):
        seen = []
        with pytest.raises(Stop):
            jcli.main(["deck.inp", "--multihost", spec])
        addr, nproc, pid = tcli.multihost_spec(spec)
        assert seen == [dict(coordinator_address=addr, num_processes=nproc,
                             process_id=pid)]
    with pytest.raises(SystemExit, match="ADDR:PORT,NPROC,PID"):
        tcli.multihost_spec("127.0.0.1:80,2")


@pytest.mark.parametrize("nodes", ["node001", "node001,host2",
                                   "node[001-015],host2",
                                   "node[007,009-015],host2"])
def test_auto_reads_slurm_as_jax(monkeypatch, nodes):
    """``--multihost auto`` in a SLURM job step: the coordinator address,
    process count and process id that JAX's SlurmCluster reads from the
    same environment."""
    from jax._src.clusters.slurm_cluster import SlurmCluster
    env = {"SLURM_JOB_ID": "4194327", "SLURM_STEP_NODELIST": nodes,
           "SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert SlurmCluster.is_env_present()
    assert tcli.multihost_spec("auto") == (
        SlurmCluster.get_coordinator_address(None, None),
        SlurmCluster.get_process_count(), SlurmCluster.get_process_id())


def test_auto_without_slurm_and_indivisible_ranks_stop(monkeypatch,
                                                      tmp_path):
    """``auto`` outside a SLURM job step stops naming the variables it
    reads; ``--halo 3`` (or ``--devices 3``) over two processes stops
    before any process joins."""
    for k in tcli.SLURM_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SLURM_JOB_ID", "7")
    with pytest.raises(SystemExit) as err:
        tcli.main(["deck.inp", "--multihost", "auto", "--device", "cpu"])
    msg = str(err.value)
    assert all(v in msg for v in tcli.SLURM_VARS)
    assert "not set: SLURM_STEP_NODELIST, SLURM_NTASKS" in msg
    for flag in ("--halo", "--devices"):
        with pytest.raises(SystemExit, match=f"{flag} 3 does not divide "
                           "over the 2 processes"):
            tcli.main([str(tmp_path / "deck.inp"), flag, "3", "--device",
                       "cpu", "--multihost", "127.0.0.1:1,2,0"])
    assert tdist.process_count() == 1

"""The host loop's and the graph layer's spans and counters on the CPU
(``utils/profiling.span``, ``solver/explicit.run_loop``'s ``timings``,
``solver/graph.totals``): under ``torch.profiler`` a ``run()`` of a tiny
deck shows a ``hakai.chunk`` a chunk, the reads of its values (one
chunk behind where the loop runs ahead) and its frames, correctly nested
and carrying the run and chunk ids; without a profiler no span is made;
``timings`` counts the chunks, those run ahead, the host loop's seconds
and its reads of device values, and the graphs captured and replayed
(none on the CPU;
on the graph path, with each capture stood in for by an eager replay as
in ``tests/test_torch_graph.py``).  The card's own graphs:
``tests/test_torch_cuda.py::test_run_counts_captures_and_replays``."""
import json
import os
import re
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hakai_tpu_torch import SolverConfig, cli as tcli, lower, run
from hakai_tpu_torch.pre import synthetic as tsyn
from hakai_tpu_torch.solver import explicit
from hakai_tpu_torch.solver.graph import GRAPH_STEPS as K, ChunkGraphs
from hakai_tpu_torch.utils import profiling
from rank_workers import stand_in_capture
from test_torch_cuda import port_fast_model

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from inp_deck import deck_text  # noqa: E402

CHUNKS = 5


def _model(tmp_path, **cfg):
    """A 2x2x4 bar of 10 steps in chunks of 2 (generic step), float64."""
    bar = tsyn.bar_model(2, 2, 4, d_time=5e-8, end_time=5e-7)
    cfg = dict(dict(dtype="float64", energy_check=True, energy_abort_rel=0.5,
                    output_num=CHUNKS, out_dir=str(tmp_path)), **cfg)
    return lower(bar, SolverConfig(**cfg), device="cpu")


def _traced(call):
    """``call()`` under the profiler: its result and its ``hakai.*`` spans
    as (name, start ns, end ns, ids) in start order."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        out = call()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              dict(e.kwinputs()))
             for e in p.profiler.kineto_results.events()
             if e.name().startswith("hakai.")]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _parent(span, spans):
    """The innermost other span holding ``span``."""
    holders = [s for s in spans if s is not span and s[1] <= span[1]
               and span[2] <= s[2]]
    return min(holders, key=lambda s: s[2] - s[1])[0] if holders else None


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_spans_nest_and_carry_run_and_chunk(tmp_path, monkeypatch):
    """A ``hakai.chunk`` a chunk, a ``hakai.frame`` a frame holding its
    gather, mapping and write, all inside the one ``hakai.run``, each
    carrying the run and (after the first chunk starts) the chunk; a
    second ``run()`` a new run id.  With a frame after every chunk the
    loop does not run ahead: each chunk's ``hakai.chunk.sync`` (the wait
    for its values) lies in its own ``hakai.chunk``, before its frame.
    Without frames chunk k's values are read in chunk k+1's
    ``hakai.chunk``, after ``run_chunk`` has queued chunk k+1; only the
    last chunk's in its own.  The guards read those values: no
    ``hakai.guard.*`` span but the alive count before the first chunk."""
    calls = explicit.run_chunk

    def marked(*a, **k):                      # a span around each call
        with profiling.span("hakai.test.run_chunk"):
            return calls(*a, **k)
    monkeypatch.setattr(explicit, "run_chunk", marked)
    m = _model(tmp_path)
    _, spans = _traced(lambda: run(m, verbose=False, device="cpu"))
    (run_span,) = _named(spans, "hakai.run")
    rid = run_span[3]["run"]
    assert all(s[3]["run"] == rid for s in spans)
    assert all(_parent(s, spans) is not None for s in spans
               if s is not run_span)
    assert _parent(_named(spans, "hakai.run.enter")[0], spans) == "hakai.run"
    chunks = _named(spans, "hakai.chunk")
    assert [c[3]["chunk"] for c in chunks] == list(range(CHUNKS))
    assert all(c[3]["steps"] == 2 for c in chunks)
    for name, parent in (("hakai.chunk", "hakai.run"),
                         ("hakai.chunk.sync", "hakai.chunk"),
                         ("hakai.frame", "hakai.run"),
                         ("hakai.frame.gather", "hakai.frame"),
                         ("hakai.frame.map", "hakai.frame"),
                         ("hakai.frame.write", "hakai.frame"),
                         ("hakai.pvd", "hakai.run")):
        assert {_parent(s, spans) for s in _named(spans, name)} == {parent}
    syncs = _named(spans, "hakai.chunk.sync")
    frames = _named(spans, "hakai.frame")
    assert [s[3]["chunk"] for s in syncs] == list(range(CHUNKS))
    for j, c in enumerate(chunks):      # each read in its chunk, then frame
        assert c[1] <= syncs[j][1] and syncs[j][2] <= c[2]
        assert c[2] <= frames[j + 1][1]
        assert j + 1 == CHUNKS or frames[j + 1][2] <= chunks[j + 1][1]
    assert not _named(spans, "hakai.guard.energy")
    assert len(_named(spans, "hakai.guard.alive")) == 1
    assert [f[3]["frame"] for f in frames] == list(range(CHUNKS + 1))
    for name in ("hakai.frame.gather", "hakai.frame.map",
                 "hakai.frame.write"):
        assert len(_named(spans, name)) == CHUNKS + 1
    assert "chunk" not in frames[0][3] and frames[1][3]["chunk"] == 0
    assert not _named(spans, "hakai.graph.capture")    # the CPU: eager
    _, again = _traced(lambda: run(m, verbose=False, write_output=False,
                                   device="cpu"))
    assert {s[3]["run"] for s in again} == {rid + 1}
    chunks = _named(again, "hakai.chunk")
    syncs = _named(again, "hakai.chunk.sync")
    queued = _named(again, "hakai.test.run_chunk")
    assert [s[3]["chunk"] for s in syncs] == list(range(CHUNKS))
    assert len(chunks) == len(queued) == CHUNKS
    for k in range(CHUNKS):         # chunk k read after chunk k+1 queued
        c = chunks[min(k + 1, CHUNKS - 1)]
        assert c[1] <= syncs[k][1] and syncs[k][2] <= c[2]
        assert queued[min(k + 1, CHUNKS - 1)][2] <= syncs[k][1]
    assert not profiling.IDS                   # cleared when a run ends


def test_no_span_without_a_profiler(tmp_path, monkeypatch):
    """Without a profiler a run makes no RecordFunction at all, with every
    span of the loop reached (frames, guards, metrics, checkpoints); under
    one the same patch is reached."""
    def refuse(*a, **k):
        raise AssertionError("a span without a profiler")
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", refuse)
    m = _model(tmp_path, check_nan=True, checkpoint_every=2,
               metrics_path=str(tmp_path / "m.jsonl"))
    run(m, verbose=False, device="cpu")
    assert (tmp_path / "ckpt_002.npz").exists()
    with pytest.raises(AssertionError, match="without a profiler"):
        _traced(lambda: run(m, verbose=False, device="cpu"))


@pytest.mark.parametrize("guards", ["alive", "energy", "nan", "metrics"])
def test_timings_count_the_loop(tmp_path, guards):
    """``host_syncs``: the step count and the alive count before the
    loop, then one read a chunk, whatever the guards and the stream read
    (the alive count, the NaN flag, the energy ratio and every metric
    value come as one copy); ``ahead``: without frames every chunk but
    the first is queued before the previous chunk's values are read; no
    graphs on the CPU.  ``metrics_s``: the stream's seconds, a part of
    ``loop_s``."""
    cfg = {"alive": dict(energy_check=False, energy_abort_rel=0.0),
           "energy": {}, "nan": dict(check_nan=True),
           "metrics": dict(metrics_path=str(tmp_path / "m.jsonl"))}[guards]
    m = _model(tmp_path, **cfg)
    tm = {}
    run(m, verbose=False, write_output=False, device="cpu", timings=tm)
    if guards == "metrics":
        recs = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
        assert len(recs) == CHUNKS
    assert tm["host_syncs"] == 2 + CHUNKS
    assert tm["ahead"] == CHUNKS - 1
    assert (tm["chunks"], tm["steps"], tm["frames"]) == (CHUNKS, 10, 0)
    assert (tm["captures"], tm["replays"], tm["capture_s"]) == (0, 0, 0.0)
    assert tm["loop_s"] > 0 and tm["step_s"] > 0
    assert (tm["metrics_s"] > 0) == (guards == "metrics")
    assert tm["metrics_s"] < tm["loop_s"]


def test_graph_spans_and_counters(tmp_path, monkeypatch):
    """The graph path, each capture an eager stand-in: in each chunk its
    copy-in, then in the first chunk of each ``run()`` one capture a
    length, its replays, its copy-out, all inside ``hakai.chunk``, and
    from the second chunk on the wait for the previous chunk's values;
    ``timings`` counts the captures of the run and
    ``chunks x (q + (r > 0))`` replays."""
    monkeypatch.setattr(explicit, "uses_graphs", lambda *a, **k: True)
    monkeypatch.setattr(ChunkGraphs, "_capture", stand_in_capture)
    n = K + 5                                 # q = 1, r = 5
    bar = tsyn.bar_model(4, 4, 16, d_time=5e-8,
                         end_time=(3 * n + 0.5) * 5e-8)
    m = port_fast_model(bar, SolverConfig(dtype="float32", output_num=3))
    assert m.time_num == 3 * n
    for _ in range(2):
        tm = {}
        _, spans = _traced(lambda: run(m, verbose=False, write_output=False,
                                       device="cpu", timings=tm))
        assert (tm["captures"], tm["replays"], tm["chunks"]) == (2, 6, 3)
        assert tm["capture_s"] > 0
        chunks = _named(spans, "hakai.chunk")
        for name, per in (("hakai.chunk.load", 1), ("hakai.chunk.unload", 1),
                          ("hakai.graph.replay", 2)):
            got = _named(spans, name)
            assert len(got) == 3 * per
            assert {_parent(s, spans) for s in got} == {"hakai.chunk"}
            assert [s[3]["chunk"] for s in got] == sorted(
                j for j in range(3) for _ in range(per))
        caps = _named(spans, "hakai.graph.capture")
        assert [(s[3]["chunk"], s[3]["steps"]) for s in caps] == \
            [(0, K), (0, 5)]
        assert {_parent(s, spans) for s in caps} == {"hakai.chunk"}
        def inside(c):
            return [s[0] for s in spans if c[1] <= s[1] <= c[2]
                    and s[0] != "hakai.chunk"
                    and _parent(s, spans) == "hakai.chunk"]
        assert inside(chunks[0]) == [
            "hakai.chunk.load", "hakai.graph.capture", "hakai.graph.replay",
            "hakai.graph.capture", "hakai.graph.replay",
            "hakai.chunk.unload"]
        assert inside(chunks[1]) == [   # then chunk 0's values are read
            "hakai.chunk.load", "hakai.graph.replay", "hakai.graph.replay",
            "hakai.chunk.unload", "hakai.chunk.sync"]


def test_cli_timings_and_profile_name_the_counters_and_spans(tmp_path,
                                                             capsys):
    """``--timings`` prints the counters on a second ``timings:`` line and
    ``--profile`` writes the spans with their ids into the trace."""
    deck = tmp_path / "deck.inp"
    deck.write_text(deck_text(tsyn.bar_model(2, 2, 4, d_time=5e-8,
                                             end_time=5e-7)))
    tcli.main([str(deck), "--device", "cpu", "--no-output", "--output-num",
               "5", "--profile", str(tmp_path / "prof"), "--timings"])
    out = capsys.readouterr().out
    assert re.search(r"^timings: parse ", out, re.M)
    line = re.search(r"^timings: capture ([0-9.]+) s for (\d+) graphs, "
                     r"(\d+) replays, host loop ([0-9.]+) s, (\d+) host "
                     r"syncs in (\d+) chunks$", out, re.M)
    assert line and line.group(2, 3, 6) == ("0", "0", "5")
    assert int(line.group(5)) == 2 + 5      # one read a chunk
    assert re.search(r"^timings: metrics 0\.000 s for 0 records$", out,
                     re.M)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    chunks = [e for e in events["traceEvents"]
              if e.get("name") == "hakai.chunk"]
    assert [e["args"]["chunk"] for e in chunks] == list(range(5))
    assert len({e["args"]["run"] for e in chunks}) == 1

"""``run()``'s host loop runs one chunk ahead of its reads
(``solver/explicit.run_loop``), on the CPU, where the copy of a chunk's
values is synchronous but the order is the card's: chunk k's values are
queued, chunk k+1 is queued, and only then are chunk k's values read and
acted on.  Held against a loop that reads each chunk as it ends:
``run_chunk`` chunk by chunk, the guards and ``step_metrics`` on each end
state.  The same final state, records, console lines and errors; no
running ahead past a frame or a checkpoint.  The card's run:
``tests/test_torch_cuda.py::test_run_reads_one_chunk_behind``."""
import json
import re

import pytest
import torch

from hakai_tpu_torch import SolverConfig, init_state, lower, run
from hakai_tpu_torch.pre import synthetic as tsyn
from hakai_tpu_torch.solver import explicit
from hakai_tpu_torch.utils.checkpoint import load_checkpoint
from hakai_tpu_torch.utils.metrics import energy_guard, step_metrics

CHUNKS = 5


def _bar(tmp_path, **cfg):
    """A 2x2x4 bar of 10 steps in chunks of 2 (generic step), float64."""
    bar = tsyn.bar_model(2, 2, 4, d_time=5e-8, end_time=5e-7)
    cfg = dict(dict(dtype="float64", energy_check=True, energy_abort_rel=0.5,
                    output_num=CHUNKS, out_dir=str(tmp_path)), **cfg)
    return lower(bar, SolverConfig(**cfg), device="cpu")


def _ductile(tmp_path, dtype):
    """A 4x4x16 ductile bar of 200 steps in 8 chunks, elements deleted in
    its first chunks, with the NaN check, the energy guard and a stream."""
    bar = tsyn.bar_model(4, 4, 16, d_time=5e-8, end_time=1e-5, ductile=True)
    return lower(bar, SolverConfig(
        dtype=dtype, energy_check=True, energy_abort_rel=0.5, check_nan=True,
        output_num=8, metrics_path=str(tmp_path / "m.jsonl"),
        out_dir=str(tmp_path)), device="cpu")


def _counted(monkeypatch, poison=None):
    """``explicit.run_chunk`` counting its calls (``calls[0]``); the state
    returned by call ``poison`` (from 0) gets a NaN in its displacement."""
    chunk, calls = explicit.run_chunk, [0]

    def counting(model, state, n, comm=None):
        out = chunk(model, state, n, comm)
        if calls[0] == poison:
            disp = out.disp.clone()
            disp[0, 0] = float("nan")
            out = out.replace(disp=disp)
        calls[0] += 1
        return out
    monkeypatch.setattr(explicit, "run_chunk", counting)
    return calls


def _read_as_it_ends(m):
    """The loop with each chunk's values read as it ends: (final state,
    records less ``wall_s``, console text less the wall line, the error
    raised or None)."""
    cfg = m.config
    d_out = max(m.time_num // cfg.output_num, 1)
    state = init_state(m)
    done, out, recs = 0, [], []
    alive_prev = int(state.element_flag.sum())
    while done < m.time_num:
        n = min(d_out, m.time_num - done)
        state = explicit.run_chunk(m, state, n)
        done += n
        alive = int(state.element_flag.sum())
        if cfg.check_nan and not bool(torch.isfinite(state.disp).all()):
            return state, recs, "".join(out), \
                f"NaN/Inf in displacement at step {done}"
        rel = float(energy_guard(m, state))
        if rel > cfg.energy_abort_rel:
            return state, recs, "".join(out), (
                f"energy balance diverged at step {done}: "
                f"|KE - KE0 - W_ext + W_int| = {rel:.3e} of the energy "
                f"scale (> {cfg.energy_abort_rel:.3e}) — roundoff energy "
                "injection; re-run with --precision f64 or mixed")
        if alive != alive_prev:
            out.append(f"Element deleted:{alive}/{m.n_element}\n")
            alive_prev = alive
        out.append(f"\r{done * m.dt:.4e} / {m.end_time:.4e}     ")
        if cfg.metrics_path:
            recs.append(dict({k: float(v) for k, v in
                              step_metrics(m, state).items()},
                             step=done, time=done * m.dt))
    return state, recs, "".join(out), None


def _records(path):
    recs = [json.loads(x) for x in open(path)]
    for r in recs:
        del r["wall_s"]
    return recs


@pytest.mark.parametrize("dtype", ["float64", "mixed"])
def test_run_matches_reading_each_chunk_as_it_ends(tmp_path, capsys, dtype,
                                                   monkeypatch):
    """A ductile bar whose elements erode: ``run()`` (running ahead: every
    chunk but the first queued before the previous one is read) gives
    the final state bit for bit, every record but its wall seconds and
    every console line of the loop that reads each chunk as it ends."""
    m = _ductile(tmp_path, dtype)
    calls = _counted(monkeypatch)
    want, recs, text, err = _read_as_it_ends(m)
    assert err is None and "Element deleted" in text
    assert calls[0] == 8
    capsys.readouterr()
    tm = {}
    got = run(m, write_output=False, device="cpu", timings=tm)
    console = capsys.readouterr().out
    assert calls[0] == 16 and (tm["chunks"], tm["ahead"]) == (8, 7)
    assert re.sub(r"\nwall: [0-9.]+s for 200 steps\n$", "", console) == text
    assert _records(tmp_path / "m.jsonl") == recs
    for f in ("t", "disp", "disp_pre", "velo", "Q", "stress", "strain",
              "eq_ps", "yield_s", "triax", "element_flag", "contact_force",
              "work"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("guard", ["energy", "nan"])
def test_guard_trips_after_its_chunk(tmp_path, monkeypatch, guard):
    """A guard that trips raises the error, at the step, that reading each
    chunk as it ends raises, with one more ``run_chunk`` call: the chunk
    queued ahead, then dropped.  The energy guard at a tiny bound trips
    after the first chunk; the NaN check after a NaN put into the second
    chunk's end state."""
    cfg = dict(energy_abort_rel=1e-30) if guard == "energy" else \
        dict(check_nan=True)
    m = _bar(tmp_path, **cfg)
    poison = None if guard == "energy" else 1
    calls = _counted(monkeypatch, poison)
    _, _, _, err = _read_as_it_ends(m)
    assert err is not None
    sync_calls = calls[0]
    assert sync_calls == (1 if guard == "energy" else 2)
    calls[0] = 0
    with pytest.raises(FloatingPointError) as e:
        run(m, verbose=False, write_output=False, device="cpu")
    assert str(e.value) == err
    assert calls[0] == sync_calls + 1


def test_no_run_ahead_across_frames_or_checkpoints(tmp_path, monkeypatch):
    """With a frame after every chunk and a checkpoint every second frame
    the loop reads each chunk before it queues the next: ``ahead`` is 0
    and each checkpoint holds its chunk's end state.  Resumed off the
    frames' grid (step 1 of chunks of 2) only the last chunk's end writes
    a frame, and the loop runs ahead across every other."""
    m = _bar(tmp_path, checkpoint_every=2)
    ends = []
    chunk = explicit.run_chunk

    def keeping(model, state, n, comm=None):
        ends.append(chunk(model, state, n, comm))
        return ends[-1]
    monkeypatch.setattr(explicit, "run_chunk", keeping)
    tm = {}
    run(m, verbose=False, device="cpu", timings=tm)
    assert (tm["ahead"], tm["frames"], tm["chunks"]) == (0, CHUNKS + 1,
                                                         CHUNKS)
    assert tm["host_syncs"] == 2 + CHUNKS
    for i in (2, 4):
        ck = load_checkpoint(str(tmp_path / f"ckpt_{i:03d}.npz"),
                             init_state(m))
        assert torch.equal(ck.disp, ends[i - 1].disp)
        assert int(ck.t) == 2 * i
    start = explicit.run_chunk(m, init_state(m), 1)
    out = tmp_path / "resumed"
    tm = {}
    run(_bar(out), start, verbose=False, device="cpu", timings=tm)
    assert (tm["chunks"], tm["ahead"], tm["frames"]) == (5, 4, 2)

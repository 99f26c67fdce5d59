"""Profiling hooks (mirrors ``hakai_tpu/utils/profiling.py``; the
reference's ``@time`` macro, HAKAI_j.jl:487): the ``--profile`` trace and
the spans that name what the host does in it.

A span (:func:`span`) marks a stretch of the host loop or the graph
layer, always named ``hakai.*``: the run (``hakai.run``, its entry
``hakai.run.enter``), each chunk (``hakai.chunk`` with ``.load``,
``.sync`` and ``.unload``), the graphs (``hakai.graph.capture`` with
``.warm_up`` and ``.instantiate``; ``hakai.graph.replay``), the
wait for a chunk's values (``hakai.chunk.sync``, inside the next chunk's
``hakai.chunk`` where the loop runs ahead), the readbacks of the alive
count before the first chunk and of each guard on ranks
(``hakai.guard.alive``, ``.finite``, ``.energy``), ``hakai.metrics``,
each frame (``hakai.frame`` with
``.gather``, ``.map`` and ``.write``), ``hakai.checkpoint`` and
``hakai.pvd``.  Under an active ``torch.profiler`` a span is a
RecordFunction on the profiler's clock, the clock of the card's
activity, so every idle stretch of the card in a trace lies in the span
the host was in.  With no profiler active it is one check and nothing
more.  No span is opened inside a step or a kernel wrapper: those run on
the host only while a graph is captured.

Every span carries the ids in :data:`IDS`: ``run``, a per-process count
of :func:`simulation` blocks (one a ``run()``), and inside a run
``chunk``, the index of the chunk the loop is in or has just run; a
span may add its own (a ``hakai.chunk.sync`` names the chunk it reads).  The ids are the RecordFunction's keyword values,
which a trace holds in each event's ``args`` where the profiler records
inputs (``record_shapes``, as :func:`trace` sets).
"""
from __future__ import annotations

import contextlib
import itertools
import os

import torch
from torch.autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

# the ids every span carries (``run``, ``chunk``)
IDS: dict = {}
_RUNS = itertools.count(1)
_OFF = contextlib.nullcontext()


def span(name: str, **ids):
    """A context manager that records ``name`` with :data:`IDS` and
    ``ids`` as a host span of the active profiler; with none active, a
    no-op."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunctionFast(name, (), {**IDS, **ids})


@contextlib.contextmanager
def simulation():
    """Spans made within carry a new ``run`` id (within an enclosing
    block: that block's)."""
    if "run" in IDS:
        yield
        return
    IDS["run"] = next(_RUNS)
    try:
        yield
    finally:
        IDS.clear()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace of the block (host ops and spans, with
    their ids, and the card's kernels where CUDA is available), written
    to ``<log_dir>/trace.json`` as a Chrome trace (open it in Perfetto or
    chrome://tracing); no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, record_shapes=True) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

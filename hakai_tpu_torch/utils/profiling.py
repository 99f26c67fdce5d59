"""Profiling hooks (mirrors ``hakai_tpu/utils/profiling.py``; the
reference's ``@time`` macro, HAKAI_j.jl:487)."""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace of the block (host ops, and the card's
    kernels where CUDA is available), written to
    ``<log_dir>/trace.json`` as a Chrome trace (open it in Perfetto or
    chrome://tracing); no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def timed(label: str, sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {time.perf_counter() - t0:.3f}s")

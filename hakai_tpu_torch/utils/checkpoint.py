"""Checkpoint and exact resume (mirrors ``hakai_tpu/utils/checkpoint.py``).

The whole :class:`SimState` round-trips through one ``.npz`` with the JAX
package's field names, shapes and dtypes, so a file written by either
package resumes in the other.  Resume from a same-format file is bitwise.
Older files are migrated as the JAX package migrates them: a missing work
pair restarts at zero, a per-Gauss-point strain (…, 6, 8, E) becomes its GP
mean.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.state import SimState


def save_checkpoint(path: str, state: SimState) -> str:
    leaves = {f.name: getattr(state, f.name).detach().cpu().numpy()
              for f in dataclasses.fields(state)}
    np.savez_compressed(path, **leaves)
    return path


def load_checkpoint(path: str, like: SimState) -> SimState:
    """The checkpoint at ``path`` as a state with the device, dtypes and
    shapes of ``like``."""
    data = np.load(path)
    kw = {}
    for f in dataclasses.fields(like):
        ref = getattr(like, f.name)
        if f.name == "work" and f.name not in data:
            kw[f.name] = torch.zeros_like(ref)
            continue
        arr = data[f.name]
        if (f.name == "strain" and arr.ndim == ref.dim() + 1
                and arr.shape[-2] == 8):
            arr = arr.mean(axis=-2)
        if arr.shape != tuple(ref.shape):
            raise ValueError(
                f"checkpoint field {f.name} has shape {arr.shape}, "
                f"model expects {tuple(ref.shape)}")
        kw[f.name] = torch.as_tensor(arr).to(device=ref.device,
                                             dtype=ref.dtype)
    return SimState(**kw)

"""History plotting for metrics JSONL streams, the port's own copy of
``hakai_tpu/utils/plot.py`` (matplotlib only; for the same records it
renders the same figure, ``tests/test_torch_pre.py``).

The reference's Matlab side renders displacement/stress histories with
``drawGraph`` (referenced from HAKAI-v0.0.2/Julia/HAKAI_j.jl's Matlab
mirror); the solver streams structured scalars instead
(utils/metrics.py), and this module renders those streams as a multi-panel
time-series figure.

Usage:
    python -m hakai_tpu_torch.utils.plot run/metrics.jsonl -o run/metrics.png
    python -m hakai_tpu_torch.utils.plot m.jsonl --fields kinetic_energy,d_max

Panels default to every numeric field present (minus the x axis), one
panel per field, sharing the time axis.  Energy-balance runs
(--energy-check) additionally get the balance residual panel on a log
scale, which is the divergence diagnostic the guard thresholds.
"""
from __future__ import annotations

import argparse
import json
import sys

_SKIP = {"step", "time", "wall_s"}
_LOG_FIELDS = {"energy_rel_error"}


def load_jsonl(path: str) -> list[dict]:
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    return recs


def plot_metrics(records: list[dict], out_path: str,
                 fields: list[str] | None = None, x: str = "time") -> str:
    """Render ``records`` (list of flat dicts) to ``out_path``.

    ``fields`` selects/orders panels; default is every numeric field in
    record order.  ``x`` is the shared abscissa ("time" or "step").
    """
    if not records:
        raise ValueError("no metric records to plot")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if fields is None:
        fields = [k for k, v in records[0].items()
                  if k not in _SKIP and isinstance(v, (int, float))]
    missing = [f for f in fields if f not in records[0]]
    if missing:
        raise ValueError(f"fields not in the metrics stream: {missing} "
                         f"(have: {sorted(records[0])})")
    xs = [r.get(x, i) for i, r in enumerate(records)]

    n = len(fields)
    ncol = 2 if n > 3 else 1
    nrow = -(-n // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(6.0 * ncol, 2.2 * nrow),
                             sharex=True, squeeze=False)
    for i, f in enumerate(fields):
        ax = axes[i // ncol][i % ncol]
        ys = [r.get(f) for r in records]
        ax.plot(xs, ys, lw=1.0)
        ax.set_ylabel(f, fontsize=8)
        ax.tick_params(labelsize=7)
        ax.grid(True, alpha=0.3)
        if f in _LOG_FIELDS and any(y and y > 0 for y in ys):
            ax.set_yscale("log")
    for j in range(n, nrow * ncol):
        axes[j // ncol][j % ncol].axis("off")
    for c in range(ncol):
        axes[-1][c].set_xlabel(x, fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m hakai_tpu_torch.utils.plot",
        description="Plot a hakai_tpu_torch metrics JSONL stream "
                    "(see utils/metrics.py; enable with --metrics PATH)")
    ap.add_argument("jsonl", help="metrics JSONL path")
    ap.add_argument("-o", "--out", default=None,
                    help="output image (default: <jsonl>.png)")
    ap.add_argument("--fields", default=None,
                    help="comma-separated field subset (default: all)")
    ap.add_argument("--x", default="time", choices=["time", "step"],
                    help="abscissa (default: physical time)")
    args = ap.parse_args(argv)
    out = args.out or (args.jsonl.rsplit(".", 1)[0] + ".png")
    fields = args.fields.split(",") if args.fields else None
    path = plot_metrics(load_jsonl(args.jsonl), out, fields, args.x)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())

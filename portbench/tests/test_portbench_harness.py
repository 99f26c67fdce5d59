"""The benchmark harness on the CPU at tiny sizes: files found by name,
well-formed result lines, the metric readers, the roofline count, the
control, the faults that the check must catch, and what the harness
imports and reads.  Run from the repository's root:

    python -m pytest portbench/tests -q
"""
import copy
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import roofline, run, trace  # noqa: E402
from portbench.reference import decks  # noqa: E402

CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


def tiny(name: str, root: str = ROOT) -> dict:
    """The cell with its deck cut to its generator's ``TINY`` sizes."""
    spec = copy.deepcopy(run.cell_spec(name, root))
    deck = spec["config"]["deck"]
    deck["args"].update(decks.generator(deck["generator"], root)[1])
    spec["traffic"]["output_num"] = 5
    if spec["traffic"].get("end_time") is not None:
        spec["traffic"]["end_time"] = deck["args"]["end_time"] / 2
    return spec


def tiny_frames(root: str = ROOT) -> dict:
    """The tiny bar under the ``frames`` traffic (its VTK frames checked
    exactly), as a cell of it would run."""
    spec = tiny("bar131k_mixed.steps", root)
    spec["name"] = "bar131k_mixed.frames"
    spec["traffic"] = json.load(open(os.path.join(
        root, "portbench", "traffic", "frames.json")))
    spec["traffic"].update(output_num=5,
                           end_time=decks.TINY["bar"]["end_time"] / 2)
    spec["cell"]["limits"].update(frame_cells_differ=0,
                                  frame_state_differ=0)
    return spec


def dry(spec, seed=2147483989, traced=False):
    return run.measure(spec, seed, 0.05, traced, device="cpu",
                       start=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_files_load_by_name(name):
    spec = run.cell_spec(name)
    make, small = decks.generator(spec["config"]["deck"]["generator"])
    assert callable(make) and small
    assert "write_output" in spec["traffic"]
    assert spec["cell"]["limits"]
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert "setup_s" in names and spec["per_layer"]
    for m in names:
        assert callable(run.reader(m))


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.cell_spec("no_such.cell")


# a deck generator and a plain reference that a later configuration
# brings as files of its own; each says on standard error that it ran
TWIN_DECK = """import sys
from portbench.reference.decks import bar_deck

TINY = dict(nx=4, ny=4, nz=16, d_time=5e-8, end_time=1e-5)


def deck(**args):
    print("portbench test: deck from twin_bar", file=sys.stderr)
    return bar_deck(**args)
"""
TWIN_REFERENCE = """import sys
from portbench.reference import solver


class Reference(solver.Reference):
    def __init__(self, deck, device, **kw):
        print("portbench test: reference twin_solver", file=sys.stderr)
        super().__init__(deck, device, **kw)
"""


def test_a_cell_is_added_by_adding_files(tmp_path, capsys):
    """A new configuration with its own deck generator and plain
    reference, traffic, cell and metric: files added next to the
    harness's, none of its files edited, and one more entry of each in
    BENCHMARK.json."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    pb = tmp_path / "portbench"

    def add(path, text):
        assert not path.exists(), path
        path.parent.mkdir(exist_ok=True)
        path.write_text(text)

    add(pb / "decks" / "twin_bar.py", TWIN_DECK)
    add(pb / "reference" / "twin_solver.py", TWIN_REFERENCE)
    cfg = json.load(open(pb / "configs" / "bar131k_mixed.json"))
    cfg["deck"]["generator"] = "twin_bar"
    cfg["deck"]["args"].update(decks.generator("twin_bar", str(tmp_path))[1])
    cfg["reference"] = "twin_solver"
    add(pb / "configs" / "bar_tiny.json", json.dumps(cfg))
    add(pb / "traffic" / "half.json", json.dumps(
        {"write_output": False, "end_time": 5e-6, "output_num": 5}))
    add(pb / "workloads" / "bar_tiny.half.json", json.dumps(
        json.load(open(pb / "workloads" / "bar131k_mixed.steps.json"))))
    add(pb / "metrics" / "sims.py",
        "def read(ctx):\n    return len(ctx['timings'])\n")
    bench["configs"].append(dict(bench["configs"][0], name="bar_tiny",
                                 file="portbench/configs/bar_tiny.json"))
    bench["workloads"].append({"name": "bar_tiny.half", "config": "bar_tiny",
                               "traffic": "half", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "sims", "unit": "runs",
                               "better": "higher", "source": "host_clock",
                               "layer": "host loop", "moves": "setup_s",
                               "workloads": ["bar_tiny.half"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.cell_spec("bar_tiny.half", str(tmp_path))
    capsys.readouterr()
    res = dry(spec, traced=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["sims"]["value"] >= 1
    err = capsys.readouterr().err
    assert "portbench test: deck from twin_bar" in err
    assert "portbench test: reference twin_solver" in err


@pytest.mark.parametrize("name", CELLS)
def test_dry_run_prints_a_well_formed_line(name):
    res = json.loads(json.dumps(dry(tiny(name))))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for m, v in res["metrics"].items():
        assert set(v) == {"value", "unit"}
    assert "setup_s" in res["metrics"]
    assert "elem_steps_per_s" in res["metrics"]
    for k, c in res["checks"].items():
        assert c["value"] <= c["limit"], k


def test_frames_dry_run_checks_its_frames():
    res = dry(tiny_frames())
    assert res["correct"], res["checks"]
    assert {"frame_cells_differ", "frame_state_differ"} <= set(
        res["checks"])


def test_traced_dry_run_reports_layers():
    res = dry(tiny("bar131k_mixed.steps"), traced=True)
    assert {"lower_s", "chunk_us_per_step"} <= set(res["metrics"])
    # no device on the CPU: its metrics are left out, never 0
    assert "element_roofline" not in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def _ctx(trace_=None, **kw):
    ctx = dict(setup_s=7.5, lower_s=0.5, window_s=2.0, elem_steps=4e9,
               mem_window_peak=3 * 2**30,
               timings=[{"step_s": 1.0, "steps": 10000, "frame_s": 2.6,
                         "frames": 2},
                        {"step_s": 1.2, "steps": 10000, "frame_s": 0.0,
                         "frames": 0}],
               trace=trace_, E=131072, N=141312, dtype="mixed",
               fracture=True, steps_per_sim=10)
    ctx.update(kw)
    return ctx


def test_readers_on_hand_made_timings_and_events():
    ns = 1_000_000
    tr = {"window": (0, 100 * ns),
          "device": [("void element_kernel<float>", 10 * ns, 20 * ns),
                     ("void element_kernel<float>", 15 * ns, 45 * ns),
                     ("narrow_probe", 60 * ns, 70 * ns),
                     ("broad_range", 65 * ns, 75 * ns),
                     ("Memcpy DtoD", 95 * ns, 105 * ns)],
          "host": [("cudaGraphLaunch", 40 * ns, 80 * ns),
                   ("aten::copy_", 50 * ns, 55 * ns)]}
    ctx = _ctx(tr)
    read = {m: run.reader(m) for m in (
        "elem_steps_per_s", "device_mem_peak_gib", "setup_s", "lower_s",
        "chunk_us_per_step", "frame_ms", "device_idle_share",
        "device_idle_share.frames", "element_roofline",
        "contact_us_per_step", "frames_sim_s")}
    assert read["elem_steps_per_s"](ctx) == 2e9
    assert read["device_mem_peak_gib"](ctx) == 3.0
    assert read["setup_s"](ctx) == 7.5 and read["lower_s"](ctx) == 0.5
    assert read["chunk_us_per_step"](ctx) == pytest.approx(110.0)
    assert read["frame_ms"](ctx) == pytest.approx(1300.0)
    # busy: 10-45, 60-75, 95-100 ms of 100
    assert read["device_idle_share"](ctx) == pytest.approx(0.45)
    assert read["device_idle_share.frames"](ctx) == pytest.approx(0.45)
    assert read["frames_sim_s"](ctx) == 1.0
    mean_s = 20e-3
    assert read["element_roofline"](ctx) == pytest.approx(
        roofline.element_bound_s(131072, 141312, "mixed", True) / mean_s
        * 100)
    assert read["contact_us_per_step"](ctx) == pytest.approx(2000.0)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["void element_kernel<float>", 0.04]
    assert b["idle_gaps"][:2] == [["no host span", pytest.approx(0.02)],
                                  ["aten::copy_", pytest.approx(0.015)]]
    none = _ctx(None, mem_window_peak=None,
                timings=[{"step_s": 1.0, "steps": 5, "frame_s": 0.0,
                          "frames": 0}])
    for m in ("device_idle_share", "element_roofline", "contact_us_per_step",
              "frame_ms", "device_mem_peak_gib"):
        assert read[m](none) is None
    contactless = _ctx({"window": (0, 10), "device": [("k", 0, 5)],
                        "host": []})
    assert read["contact_us_per_step"](contactless) is None


def test_element_roofline_count_by_hand():
    """E = 2, N = 3 in mixed, with triaxiality: per element elem 32 B,
    coord_e 96, P 288, G and lam 8, mat_id 4, has_plastic and flag 2, out
    P 288, qe 96, triax 32 = 846 B; per node disp and dprev 48 B."""
    assert roofline.element_bytes(2, 3, "mixed", True) == 2 * 846 + 3 * 48
    assert roofline.element_bytes(2, 3, "float64", False) == \
        2 * (32 + 98 * 8 + 6 + 96 * 8) + 3 * 48
    E, N = 131072, 141312
    assert roofline.element_bound_s(E, N, "mixed", True) == pytest.approx(
        (E * 846 + N * 48) / 3.35e12)


def test_no_jax_after_a_dry_run():
    """A dry run in a fresh interpreter leaves no module whose top-level
    name is jax, jaxlib, flax or hakai_tpu (hakai_tpu_torch passes)."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench import run\n"
        "from portbench.tests.test_portbench_harness import "
        "tiny_frames, dry\n"
        "dry(tiny_frames())\n"
        "print(run.forbidden_modules(), 'hakai_tpu_torch' in sys.modules)\n"
        % ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hakai_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "hakai_tpu.io", sys)
    assert run.forbidden_modules() == ["hakai_tpu.io"]


def test_harness_reads_no_jax_benchmark():
    """No file of the harness names bench.py, benchmarks/ or the JAX
    package's BENCH_*.json, and a dry run opens none of them."""
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if f.endswith(".py") and not f.startswith("test_"):
                text = open(os.path.join(dirpath, f)).read()
                for word in ("bench.py", "benchmarks/", "BENCH_",
                             "import jax", "hakai_tpu."):
                    assert word not in text, (f, word)


def test_cli_refuses_without_a_card():
    """No CUDA device: exit code 2 and nothing on standard output."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bar131k_mixed.steps", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """One short run of the bar's steps cell through the command."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bar131k_mixed.steps", "--seed", "2147483648", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]

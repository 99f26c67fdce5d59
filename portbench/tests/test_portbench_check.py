"""The check that decides ``correct``, at tiny sizes on the CPU: the
control (the program's own float32 path) reads far above the program, and
each fault of the timed path that a cell can have turns ``correct``
false while the harness's run goes on around it.  The control's readings
at the cells' own sizes come from ``portbench/control.py`` on the card
(PERF.md).

    python -m pytest portbench/tests -q
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import control, faults  # noqa: E402
from portbench.tests.test_portbench_harness import (  # noqa: E402
    CELLS, dry, tiny, tiny_frames)


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_far_above_the_program(name):
    out = control.readings(tiny(name), 2147483659, True, device="cpu")
    prog, ctrl = out["program"], out["control"]
    for k in ("disp_q90", "stress_q90"):
        assert ctrl[k] > 3 * prog[k], (k, prog[k], ctrl[k])


# the faults that each cell can have: every cell's chunk, assembly and
# result; erosion and contact where the cell's deck has them
CELL_FAULTS = [(name, f) for name in CELLS
               for f in ("unchanged", "half_elements", "altered")] + \
    [("impact120k_mixed.steps", f) for f in ("no_erosion", "half_contact")]


@pytest.mark.parametrize("name,fault", CELL_FAULTS)
def test_fault_turns_correct_false(name, fault):
    with faults.planted(fault):
        res = dry(tiny(name))
    assert not res["correct"], res["checks"]
    assert res["failed"] == res["attempted"]


@pytest.mark.parametrize("fault,number", [("no_erosion", "erosion_differ"),
                                          ("half_contact",
                                           "contact_force_q90")])
def test_local_fault_is_seen_by_its_own_number(fault, number):
    """Erosion dropped and contact halved each fail the number of the
    entries they touch, whatever the percentiles over all entries read."""
    with faults.planted(fault):
        res = dry(tiny("impact120k_mixed.steps"))
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def test_altered_frame_turns_correct_false():
    with faults.planted("altered_frame"):
        res = dry(tiny_frames())
    assert not res["correct"]
    bad = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert bad == ["frame_state_differ"], bad


def _readings(name):
    """The cell's readings on the card (``portbench/readings/``): the
    lines of ``control.py`` and the ``checks`` of the benchmark's runs."""
    import glob
    import json
    rows = []
    for path in sorted(glob.glob(os.path.join(
            ROOT, "portbench", "readings", name + ".*.jsonl"))):
        rows += [json.loads(line) for line in open(path)]
    return rows


@pytest.mark.parametrize("name", CELLS)
def test_limits_lie_between_their_readings(name):
    """Every sound run on the card reads under each limit; the control
    and every planted fault read over at least one."""
    import math
    from portbench import check, run
    limits = run.cell_spec(name)["cell"]["limits"]
    rows = _readings(name)
    assert rows
    sound = [r["program"] for r in rows if "program" in r] + [
        {k: c["value"] for k, c in r["checks"].items()}
        for r in rows if "checks" in r]
    bad = [{k: v for k, v in r[key].items() if k in limits}
           for r in rows for key in r
           if key == "control" or (key.startswith("fault_")
                                   and not key.endswith("_chunks"))]
    assert len(sound) >= 4 and bad
    for nums in sound:
        for k, v in nums.items():
            if k in limits:
                assert math.isfinite(v) and v < limits[k] or \
                    v == limits[k] == 0, (k, v, limits[k])
    for nums in bad:
        assert not check.judge(nums, limits), nums

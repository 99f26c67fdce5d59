"""The port runs without JAX and without the JAX package: a fresh
interpreter imports every module of hakai_tpu_torch (``parallel``
included), builds the ductile bar and the impact contact deck from the
port's own pre.synthetic and runs run() on each on the CPU, the bar also
on two element-sharded ranks and on two halo ranks, the bandwidth probe
at a small size; ``python -m hakai_tpu_torch deck.inp
--device cpu`` runs a written deck; no module of jax or hakai_tpu is ever
loaded, in the interpreter or in a spawned rank.
And no source file of the port, nor chip_smoke.py or the deck writer
scripts/inp_deck.py, has an import of either."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "hakai_tpu")

SCRIPT = """
import importlib, pkgutil, sys, tempfile
sys.path.insert(0, {root!r})
import torch
import hakai_tpu_torch as ht
for mod in pkgutil.walk_packages(ht.__path__, "hakai_tpu_torch."):
    importlib.import_module(mod.name)
from hakai_tpu_torch.pre.synthetic import bar_model
out = tempfile.mkdtemp()
cfg = ht.SolverConfig(dtype="mixed", output_num=2, energy_check=True,
                      out_dir=out, metrics_path=out + "/m.jsonl")
m = ht.lower(bar_model(4, 4, 16, d_time=5e-8, end_time=5e-7, ductile=True),
             cfg, device="cpu")
s = ht.run(m, verbose=False, device="cpu")
assert int(s.t) == m.time_num == 10 and bool(torch.isfinite(s.disp).all())
s2 = ht.run(m, verbose=False, write_output=False, devices=2, device="cpu")
assert torch.equal(s2.disp, s.disp)
s3 = ht.run(m, verbose=False, write_output=False, halo=2, device="cpu")
assert int(s3.t) == 10
assert (s3.disp - s.disp).abs().max() <= 1e-6 * s.disp.abs().max()
from hakai_tpu_torch.parallel.dist import launch, rank_info
info = launch(rank_info, 2, "cpu", None, [dict(halo=True, model=m, chunks=[3])])
assert info["world"] == 2 and "hakai_tpu_torch.parallel.halo" in info["modules"]
from hakai_tpu_torch.probes.dma import probe
probe(E=256, TE=128, n1=1, n2=2, device="cpu", out=lambda *a: None)
from hakai_tpu_torch.pre.synthetic import impact_model
m = ht.lower(impact_model(n=2, v0=8.0e4, d_time=4e-8, end_time=1.01e-6),
             cfg, device="cpu")
s = ht.run(m, verbose=False, device="cpu")
assert len(m.pairs) == 2 and int(s.t) == m.time_num == 25
assert float(s.contact_force.abs().max()) > 0
bad = sorted(k for k in list(sys.modules) + info["modules"]
             if k.split(".")[0] in {forbidden!r})
print("FORBIDDEN_MODULES", bad)
"""


def test_port_never_imports_jax():
    r = subprocess.run(
        [sys.executable, "-c",
         SCRIPT.format(root=str(ROOT), forbidden=FORBIDDEN)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "FORBIDDEN_MODULES []" in r.stdout, r.stdout


def test_cli_never_imports_jax(tmp_path):
    """``python -m hakai_tpu_torch deck.inp --device cpu`` in a fresh
    interpreter, on a ductile bar written by scripts/inp_deck.py: it runs
    to its end, and ``-X importtime`` lists every module it imported,
    none of jax or the JAX package."""
    deck = tmp_path / "bar.inp"
    w = subprocess.run([sys.executable, str(ROOT / "scripts" / "inp_deck.py"),
                        str(deck), "2", "2", "4", "--ductile",
                        "--end-time", "1e-6"],
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert w.returncode == 0, w.stderr
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "hakai_tpu_torch",
         str(deck), "--device", "cpu", "--out-dir", str(tmp_path / "out"),
         "--output-num", "2"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "time_num:20" in r.stdout
    assert (tmp_path / "out" / "file002.vtk").exists()
    mods = [line.rsplit("|", 1)[1].strip() for line in r.stderr.splitlines()
            if line.startswith("import time:") and "|" in line]
    assert "hakai_tpu_torch.cli" in mods and "torch" in mods
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def _imports(path: Path):
    """Top-level package names of every import statement in ``path``,
    including those inside functions (relative imports excluded)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "hakai_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "inp_deck.py"]
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(set(_imports(p))
                                            & set(FORBIDDEN))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}, bad
    assert os.path.exists(ROOT / "hakai_tpu_torch" / "pre" / "synthetic.py")

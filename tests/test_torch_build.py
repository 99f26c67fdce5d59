"""The kernel build recipe (hakai_tpu_torch._build): what nvcc is asked to
compile, without a compiler (the card's smoke run builds and loads it)."""
import re
from pathlib import Path

from hakai_tpu_torch import _build


def test_build_command_targets_hopper_and_every_source():
    """One nvcc process per source (they run at once), each compiling for
    sm_90a to a position-independent object; one link of the objects into
    the shared library."""
    compiles, link, objs = _build.build_commands("nvcc", Path("out.so"))
    cu = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert cu == ["assemble.cu", "broad.cu", "contact.cu", "element.cu",
                  "erosion.cu", "gather.cu", "integrate.cu", "interleave.cu",
                  "stream.cu"]
    assert len(compiles) == len(cu) == len(objs)
    for cmd in compiles:
        assert cmd[0] == "nvcc" and "-c" in cmd
        assert "arch=compute_90a,code=sm_90a" in cmd and "-fPIC" in cmd
        # the contact, integrate, erosion and broad-phase sources keep
        # every operation separately rounded, in the association order of
        # their plain versions
        src = Path(cmd[cmd.index("-c") + 1]).name
        assert ("-fmad=false" in cmd) == (src in ("contact.cu",
                                                  "integrate.cu",
                                                  "erosion.cu", "broad.cu"))
    assert sorted(Path(c[c.index("-c") + 1]).name for c in compiles) == cu
    assert link[0] == "nvcc" and "-shared" in link
    assert link[-2:] == ["-o", "out.so"]
    assert [str(o) for o in objs] == link[2:-2]


def test_every_c_entry_point_is_declared():
    """Each extern "C" entry in the sources has ctypes argument types, so
    no pointer is passed as a 32-bit int."""
    declared = set(_build._SIGNATURES) | {"hk_error_string"}
    defined = set()
    for p in _build.CSRC.glob("*.cu"):
        text = p.read_text()
        body = text[text.index('extern "C" {'):]
        for tok in body.replace("(", " ").split():
            if tok.startswith("hk_"):
                defined.add(tok)
    assert defined == declared


def test_c_entry_arguments_match_their_declarations():
    """Each extern "C" entry takes as many arguments as its ctypes
    declaration passes, so a kernel's new parameter (the element kernel's
    hardening-table row count) reaches every call."""
    seen = set()
    for p in _build.CSRC.glob("*.cu"):
        text = p.read_text()
        body = text[text.index('extern "C" {'):]
        for m in re.finditer(r"\b(hk_\w+)\(([^)]*)\)\s*\{", body):
            name, params = m.groups()
            if name == "hk_error_string":
                continue
            n = len([x for x in params.split(",") if x.strip()])
            assert len(_build._SIGNATURES[name]) == n, name
            seen.add(name)
    assert seen == set(_build._SIGNATURES)

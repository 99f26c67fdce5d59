"""The kernel build recipe (hakai_tpu_torch._build): what nvcc is asked to
compile, without a compiler (the card's smoke run builds and loads it)."""
from pathlib import Path

from hakai_tpu_torch import _build


def test_build_command_targets_hopper_and_every_source():
    """One nvcc process per source (they run at once), each compiling for
    sm_90a to a position-independent object; one link of the objects into
    the shared library."""
    compiles, link, objs = _build.build_commands("nvcc", Path("out.so"))
    cu = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert cu == ["assemble.cu", "contact.cu", "element.cu", "gather.cu",
                  "stream.cu"]
    assert len(compiles) == len(cu) == len(objs)
    for cmd in compiles:
        assert cmd[0] == "nvcc" and "-c" in cmd
        assert "arch=compute_90a,code=sm_90a" in cmd and "-fPIC" in cmd
        # the contact source alone keeps every operation separately
        # rounded, in the association order of its plain version
        src = Path(cmd[cmd.index("-c") + 1]).name
        assert ("-fmad=false" in cmd) == (src == "contact.cu")
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

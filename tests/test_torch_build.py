"""The kernel build recipe (hakai_tpu_torch._build): what nvcc is asked to
compile, without a compiler (the card's smoke run builds and loads it)."""
from pathlib import Path

from hakai_tpu_torch import _build


def test_build_command_targets_hopper_and_every_source():
    cmd = _build.build_command("nvcc", Path("out.so"))
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd
    cu = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert cu == ["assemble.cu", "element.cu"]
    assert sorted(Path(a).name for a in cmd if a.endswith(".cu")) == cu


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

"""The kernel build recipe (hakai_tpu_torch._build): what nvcc is asked to
compile, without a compiler (the card's smoke run builds and loads it);
and the one launch protocol, :func:`_build.launch`, against a stand-in
library."""
import collections
import contextlib
import re
from pathlib import Path

import pytest
import torch

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


class _StandIn:
    """A kernel library whose ``hk_probe`` records its arguments and
    returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def hk_probe(self, *args):
        self.calls.append(args)
        return self.err

    def hk_error_string(self, err):
        return b"stand-in error"

    def __getattr__(self, name):
        # any other entry records its calls as hk_probe does
        return self.hk_probe


def _stand_in(monkeypatch, lib, counts):
    """Launch through ``lib`` on a stream numbered 4242, counting into
    ``counts``."""
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device:
                        type("Stream", (), {"cuda_stream": 4242})())
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter(counts))


@pytest.mark.parametrize("err", [0, 700])
def test_launch_passes_pointers_and_stream_checks_and_counts(monkeypatch,
                                                             err):
    """A tensor passes as its data pointer, None as NULL and a number as
    itself, the stream last; a launch that fails raises with its entry's
    name and is not counted, one that succeeds adds 1 to its entry."""
    lib = _StandIn(err)
    _stand_in(monkeypatch, lib, {"hk_other": 2})
    x = torch.arange(6.0)
    args = ("hk_probe", torch.device("cpu"), x, None, 3, 0.5, x[2:])
    if err:
        with pytest.raises(RuntimeError, match="hk_probe: CUDA error 700"):
            _build.launch(*args)
    else:
        _build.launch(*args)
    assert _build.LAUNCHES == collections.Counter(
        {"hk_other": 2, "hk_probe": 0 if err else 1})
    assert lib.calls == [(x.data_ptr(), None, 3, 0.5, x.data_ptr() + 8,
                          4242)]


def test_smoke_counts_instantiations_beside_their_entry(monkeypatch):
    """chip_smoke.py's ``count_variants``: a launch of the unpacked element
    entry also counts under the outputs it is given (its last two
    pointers), one of the interleave entry under its mode, another entry
    only under its name, and a launch that fails under neither; a second
    call changes nothing."""
    import chip_smoke
    from hakai_tpu_torch.ops.interleave_cuda import MODES
    lib = _StandIn(0)
    _stand_in(monkeypatch, lib, {})
    monkeypatch.setattr(_build, "launch", _build.launch)   # undone after
    chip_smoke.count_variants()
    chip_smoke.count_variants()
    x, cpu = torch.zeros(2), torch.device("cpu")
    for triax, neg in ((x, x), (x, None), (None, x), (None, None)):
        _build.launch("hk_element_update_f32", cpu, x, 7, x, triax, neg)
    mode = sorted(MODES)[-1]
    _build.launch("hk_interleave_f32", cpu, x, 60, 60, 4, MODES[mode], 0, x)
    _build.launch("hk_probe", cpu, x, None)
    lib.err = 700
    with pytest.raises(RuntimeError, match="hk_element_update_f32"):
        _build.launch("hk_element_update_f32", cpu, x, x, x)
    assert _build.LAUNCHES == collections.Counter({
        "hk_element_update_f32": 4, "hk_element_update_f32[triax+neg]": 1,
        "hk_element_update_f32[triax]": 1, "hk_element_update_f32[neg]": 1,
        "hk_element_update_f32[plain]": 1, "hk_interleave_f32": 1,
        f"hk_interleave_f32[{mode}]": 1, "hk_probe": 1})
    assert len(lib.calls) == 7

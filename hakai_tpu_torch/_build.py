"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with nvcc, for Hopper (``sm_90a``), into
an object of its own (one nvcc process per source, all started together),
and the objects link into one shared library with a plain C interface,
loaded with :mod:`ctypes`.  No PyTorch header is compiled, so a build takes
seconds rather than minutes.

The library is built at first use into ``build/kernels/`` beside the
package (a directory the repository's ``.gitignore`` lists), under a file
name keyed by a hash of the sources, the flags and the compiler's version:
an edited source or flag builds a new library, an unchanged one reuses the
last build.  The sources in the checkout are the only input.

The host-IO helper (``csrc/host_io.cpp``: the ``.inp`` number parser and
the VTK number formatters) is host C++, not a kernel: :func:`host_library`
compiles it with the host compiler into ``build/host/``, keyed the same
way, on the card's machine and on a CPU alike.

Nothing here runs at import: tests on machines without nvcc import every
module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
HOST_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "host"
HOST_SOURCE = CSRC / "host_io.cpp"
# the JAX package's native/Makefile flags
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# per-source flags: the contact source keeps every multiply and add
# separately rounded, in the association order of its plain version
SOURCE_FLAGS = {"contact.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
# narrow phase: kin, R, t0, t1, t2, cs, F2, Ci, TB, nb, tri_chunks,
# n_chunks, tri_in, node_in, ok_nodes, ok_tris, list_nodes, list_tris,
# overlap, lo, mass, ids, enodes, young, kc, Cr, myu, d_lim, ddiv (element
# type), force, ld, off_i, off_t, count, iws, fws, B, stream
_NARROW = ((_P,) + (_I,) * 11 + (_P,) * 11,
           (_P, _I, _I, _I, _P, _P, _P, _I, _P))
# C entry points: (name, argument types); each returns a cudaError_t
_SIGNATURES = {
    "hk_narrow_f32": _NARROW[0] + (ctypes.c_float,) * 6 + _NARROW[1],
    "hk_narrow_f64": _NARROW[0] + (ctypes.c_double,) * 6 + _NARROW[1],
    # src, ld, ptr, mid, word, nb, bits, emax, N, out, stream
    "hk_scatter_f32": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "hk_scatter_f64": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "hk_scatter_f32_f64": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # instantiation, emax, out (as hk_element_resources)
    "hk_scatter_resources": (_I, _I, _P),
    # src, C, S, idx, R, out, stream
    "hk_gather_cols_f32": (_P, _I, _I, _P, _I, _P, _P),
    "hk_gather_cols_f64": (_P, _I, _I, _P, _I, _P, _P),
    "hk_set_pusai": (_P,),
    # elem, coord_e, disp, dprev, P, G, lam, mat, hasp, flag,
    # hard_strain, hard_slope, hard_n, hard_rows, hard_cols, E, N, P_out,
    # qe, triax (None: no triaxiality output), stream
    "hk_element_f32": (_P,) * 13 + (_I,) * 4 + (_P,) * 4,
    "hk_element_f64": (_P,) * 13 + (_I,) * 4 + (_P,) * 4,
    "hk_element_mixed": (_P,) * 13 + (_I,) * 4 + (_P,) * 4,
    # elem, position, d_disp, stress, strain, eq_ps, yield, G, lam, mat,
    # hasp, flag, hard_strain, hard_slope, hard_n, hard_rows, hard_cols, E,
    # N, stress_out, strain_out, eq_out, yield_out, qe, triax (None: no
    # triaxiality output), stream
    "hk_element_update_f32": (_P,) * 15 + (_I,) * 4 + (_P,) * 7,
    "hk_element_update_f64": (_P,) * 15 + (_I,) * 4 + (_P,) * 7,
    # instantiation, hard_rows, hard_cols, out (5 ints: blocks an SM,
    # registers, static and local bytes, dynamic shared bytes)
    "hk_element_resources": (_I, _I, _I, _P),
    # qe, inc_idx, inc_mask, V, N, E, Q, stream
    "hk_assemble_f32": (_P, _P, _P, _I, _I, _I, _P, _P),
    "hk_assemble_f64": (_P, _P, _P, _I, _I, _I, _P, _P),
    "hk_assemble_f32_f64": (_P, _P, _P, _I, _I, _I, _P, _P),
    # src, S, idx, mask, vl, r_tile, n_out, out, stream
    "hk_blocked_assemble_f32": (_P, _I, _P, _P, _I, _I, _I, _P, _P),
    "hk_blocked_assemble_f64": (_P, _I, _P, _P, _I, _I, _I, _P, _P),
    "hk_blocked_assemble_f32_f64": (_P, _I, _P, _P, _I, _I, _I, _P, _P),
    # instantiation, slots V, out (as hk_element_resources)
    "hk_assemble_resources": (_I, _I, _P),
    # x, o, rows, E, TE, layout, stream
    "hk_stream_add1_f32": (_P, _P, _I, _I, _I, _I, _P),
    # src, W, builds, n_tiles, mode, off (8 ints, host), out, stream
    "hk_interleave_f32": (_P, _I, _I, _I, _I, _P, _P, _P),
    # W, builds, n_tiles, mode, off (8 ints, host), out (as
    # hk_element_resources)
    "hk_interleave_resources": (_I, _I, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_INFO: dict = {}
_host_lib: ctypes.CDLL | None = None
HOST_INFO: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or raise on the first
    that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{o}")
    return "".join(outs)


def build_commands(nvcc: str, out: Path):
    """(one compile command per source, the link command of ``out``, the
    objects between them)."""
    srcs = [p for p in sources() if p.suffix == ".cu"]
    objs = [out.with_name(f"{out.name}.{p.stem}.o") for p in srcs]
    compiles = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(s.name, ()), "-c",
                 str(s), "-o", str(o)] for s, o in zip(srcs, objs)]
    return compiles, [nvcc, "-shared", *map(str, objs), "-o", str(out)], objs


def _compile(nvcc: str, out: Path) -> str:
    """Compile every source to an object in parallel, then link ``out``;
    returns the compiler's output (ptxas register and spill lines)."""
    compiles, link, objs = build_commands(nvcc, out)
    log = _run_all(compiles) + _run_all([link])
    for o in objs:
        o.unlink()
    return log


def _key(nvcc: str) -> str:
    h = hashlib.sha256()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout
    h.update(ver.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        key = _key(nvcc)
        so = BUILD_DIR / f"libhakai_kernels_{key}.so"
        log = so.with_suffix(".log")
        t0 = time.perf_counter()
        built = False
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            log.write_text(_compile(nvcc, tmp))
            os.replace(tmp, so)             # atomic: no half-written library
            built = True
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.hk_error_string.argtypes = [ctypes.c_int]
        lib.hk_error_string.restype = ctypes.c_char_p
        BUILD_INFO.update(path=str(so), built=built,
                          seconds=time.perf_counter() - t0,
                          log=log.read_text() if log.exists() else "")
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = lib.hk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_inputs(device, spec: dict) -> None:
    """Raise unless every tensor of ``spec`` (name -> (tensor, shape,
    dtype)) lies on ``device``, has the dtype and shape and is contiguous:
    the kernels take raw pointers and index them by these shapes."""
    for name, (x, shape, dtype) in spec.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def host_compiler() -> list[str]:
    """The host C++ compiler as a command: ``$CXX`` (split as a shell
    would), else ``c++`` or ``g++`` on PATH; raises if there is none."""
    if os.environ.get("CXX"):
        cmd = shlex.split(os.environ["CXX"])
        found = shutil.which(cmd[0])
        if not found:
            raise RuntimeError(f"host compiler CXX={os.environ['CXX']!r} not "
                               "found; the port's host-IO helper cannot be "
                               "built")
        return [found, *cmd[1:]]
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return [found]
    raise RuntimeError("no host C++ compiler (set CXX or put c++ or g++ on "
                       "PATH); the port's host-IO helper cannot be built")


def _host_key(cxx: list[str]) -> str:
    h = hashlib.sha256()
    ver = subprocess.run([*cxx, "--version"], capture_output=True,
                         text=True)
    h.update(" ".join(cxx).encode())
    h.update((ver.stdout + ver.stderr + str(ver.returncode)).encode())
    h.update(" ".join(HOST_FLAGS).encode())
    h.update(HOST_SOURCE.read_bytes())
    return h.hexdigest()[:16]


def host_library() -> ctypes.CDLL:
    """Build (once per source, flags and compiler) and load the host-IO
    helper ``build/host/libhakai_host_<hash>.so``.  Raises with the
    compiler's output if it cannot be built: its callers have no other
    path."""
    global _host_lib
    with _lock:
        if _host_lib is not None:
            return _host_lib
        cxx = host_compiler()
        HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = HOST_BUILD_DIR / f"libhakai_host_{_host_key(cxx)}.so"
        t0 = time.perf_counter()
        built = False
        if not so.exists():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [*cxx, *HOST_FLAGS, "-o", str(tmp), str(HOST_SOURCE)]
            r = subprocess.run(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"host compiler {cxx[0]} failed "
                                   f"({r.returncode}): {' '.join(cmd)}\n"
                                   f"{r.stdout}")
            os.replace(tmp, so)             # atomic: no half-written library
            built = True
        lib = ctypes.CDLL(str(so))
        lib.hk_parse_numbers.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.hk_format_e.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64]
        lib.hk_format_i.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64]
        for fn in (lib.hk_parse_numbers, lib.hk_format_e, lib.hk_format_i):
            fn.restype = ctypes.c_int64
        HOST_INFO.update(path=str(so), built=built, compiler=cxx,
                         seconds=time.perf_counter() - t0)
        _host_lib = lib
        return lib

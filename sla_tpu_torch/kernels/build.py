"""Build and load the port's native libraries, at first use.

`cuda_library()` compiles `csrc/filters.cu` with nvcc for sm_90a into a
shared library with a plain C interface and loads it with ctypes (no
PyTorch headers, so the build takes seconds). `host_library()` compiles the
same per-row bodies for the CPU with g++ (`csrc/filters_host.cpp`); only the
tests use it, and nothing on the encode or decode path calls it.

Both build into `build/sla_tpu_torch/` beside the package, keyed by a hash
of the sources and the command, under a file lock, so concurrent test
workers or processes build once and never load a half-written file. A
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "sla_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# -fwrapv: the bodies wrap through uint32 already; this keeps any stray
# signed int32 arithmetic defined the same way (the native library builds
# with it for the same reason)
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-fwrapv"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # compile time per library, this process


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _build(name: str, cmd: list[str], sources: list[pathlib.Path]) -> pathlib.Path:
    """Compile `sources` with `cmd` + [-o out, main source] unless a library
    with the same sources and command exists; returns its path."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".cpp"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while we waited
                return out
            tmp = out.with_name(out.name + f".tmp{os.getpid()}")
            t0 = time.perf_counter()
            proc = subprocess.run(
                cmd + ["-o", str(tmp)] + [str(s) for s in sources],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building {name} failed ({' '.join(cmd)}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            build_seconds[name] = time.perf_counter() - t0
            (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return out


def _load(name: str, build, bind) -> ctypes.CDLL:
    """The library `name`, built by build() and given its C signatures by
    bind(lib) the first time."""
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(build()))
            bind(lib)
            _loaded[name] = lib
        return _loaded[name]


def cuda_library() -> ctypes.CDLL:
    """The CUDA kernels (csrc/filters.cu), built for sm_90a at first use."""

    def build():
        return _build(
            "sla_filters_cuda", [nvcc_path()] + NVCC_FLAGS + ["-I", str(CSRC)],
            [CSRC / "filters.cu"],
        )

    def bind(lib):
        vp, i = ctypes.c_void_p, ctypes.c_int
        sigs = {
            "sla_lattice_predict": [vp, vp, vp, i, i, i, i, vp],
            "sla_stage2_predict": [vp, vp, vp, vp, i, i, i, i, vp],
            "sla_synth_cascade": [vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp],
            "sla_fused_encode": [vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp],
            "sla_lattice_synth": [vp, vp, vp, i, i, i, i, vp],
            "sla_lms_synth": [vp, vp, i, i, i, vp],
            "sla_longterm_synth": [vp, vp, vp, vp, vp, i, i, i, vp],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i

    return _load("sla_filters_cuda", build, bind)


def host_library() -> ctypes.CDLL:
    """The kernels' per-row bodies built for the CPU (tests only)."""

    def build():
        return _build(
            "sla_filters_host", ["g++"] + GXX_FLAGS + ["-I", str(CSRC)],
            [CSRC / "filters_host.cpp"],
        )

    def bind(lib):
        vp, i = ctypes.c_void_p, ctypes.c_int
        sigs = {  # the CUDA entries' arguments with `fixed` in place of the stream
            "sla_host_lattice_predict": [vp, vp, vp, i, i, i, i, i],
            "sla_host_stage2_predict": [vp, vp, vp, vp, i, i, i, i, i],
            "sla_host_synth_cascade": [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i],
            "sla_host_fused_encode": [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i],
            "sla_host_lattice_synth": [vp, vp, vp, i, i, i, i, i],
            "sla_host_lms_synth": [vp, vp, i, i, i, i],
            "sla_host_longterm_synth": [vp, vp, vp, vp, vp, i, i, i, i],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None

    return _load("sla_filters_host", build, bind)


def build_log(name: str = "sla_filters_cuda") -> str:
    """The compiler's output of the last build of `name` (ptxas register and
    spill counts for the CUDA library), or '' when none was kept."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""

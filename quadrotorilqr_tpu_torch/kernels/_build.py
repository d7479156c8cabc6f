"""Build the CUDA kernels and load them with ctypes.

On first use, `load()` compiles every `kernels/csrc/*.cu` with nvcc for
Hopper (`sm_90a`), one nvcc process per source, all started together, and
links the objects into one shared library with a plain C interface, under
`build/torch_kernels/` at the repository root. The library's name carries a
hash of the sources and flags, so an edited source never reuses a stale
build. Each C entry takes packed arrays of device pointers, integers and
reals plus the CUDA stream, launches on that stream without synchronizing,
and returns `cudaGetLastError()`; `launch` raises if that is not 0.

Nothing here runs at import time: the CPU tests import every module of the
port on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # print each kernel's registers and local-memory spills
    "-Xptxas", "-v",
)
ENTRIES = (
    "qilqr_backward", "qilqr_rollout", "qilqr_solve", "qilqr_fddp", "qilqr_stream",
    "qilqr_stream_fddp",
)
# the kernels built on csrc/team.cuh (every kernel), each with a
# qilqr_<name>_team_info entry
TEAM_KERNELS = ("backward", "rollout", "solve", "fddp", "stream", "stream_fddp")


class _Library:
    """The loaded kernel library, with how it was built."""

    def __init__(self, cdll, path, build_seconds, build_log):
        self.cdll = cdll
        self.path = path
        self.build_seconds = build_seconds  # None when an existing build was reused
        self.build_log = build_log


_library: _Library | None = None


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built only where the CUDA toolkit is "
        "installed (set CUDA_HOME or put nvcc on PATH)"
    )


def _declare(cdll):
    for name in ENTRIES:
        for suffix in ("f32", "f64"):
            fn = getattr(cdll, f"{name}_{suffix}")
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_void_p,
            ]
    cdll.qilqr_error_string.restype = ctypes.c_char_p
    cdll.qilqr_error_string.argtypes = [ctypes.c_int]
    # each team kernel's launch geometry (csrc/team.cuh team_info)
    for name in TEAM_KERNELS:
        fn = getattr(cdll, f"qilqr_{name}_team_info")
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ]


def load() -> _Library:
    """Build (if needed) and load the kernel library."""
    global _library
    if _library is not None:
        return _library
    path = BUILD_DIR / f"libqilqr_kernels_{source_digest()}.so"
    build_seconds = None
    build_log = ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = BUILD_DIR / f"{src.stem}_{os.getpid()}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(logs)
        failed = [proc.returncode for proc in procs if proc.returncode != 0]
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False,
            )
            build_log += link.stdout
            failed = [link.returncode] if link.returncode != 0 else []
        for obj in objs:
            obj.unlink(missing_ok=True)
        build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"nvcc failed with code {failed[0]}:\n{build_log}")
        os.replace(tmp, path)
    cdll = ctypes.CDLL(str(path))
    _declare(cdll)
    _library = _Library(cdll, path, build_seconds, build_log)
    return _library


def launch(entry: str, dtype: torch.dtype, ptrs, ints, reals, device) -> None:
    """Call `entry` (one of ENTRIES) for `dtype` on the current stream of
    `device`. `ptrs` are device pointers (ints; 0 for null)."""
    suffix = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if suffix is None:
        raise TypeError(f"the CUDA kernels take float32 or float64, not {dtype}")
    cdll = load().cdll
    with torch.cuda.device(device):  # the launch targets the runtime's current device
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(cdll, f"{entry}_{suffix}")(
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(ints))(*ints),
            (ctypes.c_double * len(reals))(*reals),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"{entry}_{suffix} launch failed: CUDA error {err} "
            f"({cdll.qilqr_error_string(err).decode()})"
        )

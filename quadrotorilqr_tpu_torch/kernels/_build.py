"""Build the CUDA kernels and load them with ctypes.

On first use, `load()` compiles every `kernels/csrc/*.cu` with nvcc for
Hopper (`sm_90a`): the exact kernels' sources (FAMILY_SOURCES) once per
model family (FAMILIES: `-DQILQR_FAMILY_T`, `-DQILQR_FAMILY`,
csrc/quadrotor.cuh), the FDDP sources once per box and weights variant
(VARIANTS), `backward.cu`'s penalty variant once more on its own
(PENALTY), one nvcc process per object, all started together, and links
the objects into one shared library with a plain C interface, under
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
# The model families the exact kernels are built for: the C entries' suffix
# (kernels/models.py LaneModel.suffix; nvcc's -DQILQR_FAMILY) -> the
# family's type in csrc/quadrotor.cuh (-DQILQR_FAMILY_T). The quadrotor's
# entries have no suffix and need no define; a 4-rotor multirotor runs them.
# The drag quadrotor and the substepped quadrotor and drag quadrotor (any k
# from 2 to 8, a runtime operand) are families of their own, so that no
# other family's object changes.
FAMILIES = {"": "Quadrotor", "_wrench": "Wrench", "_rotor6": "Multirotor<6>",
            "_rotor8": "Multirotor<8>", "_drag": "DragQuadrotor",
            "_sub": "Substepped<Quadrotor>", "_drag_sub": "Substepped<DragQuadrotor>"}
# the sources built once per family; the FDDP kernels are the quadrotor's alone
FAMILY_SOURCES = ("backward", "rollout", "solve", "stream")
# The FDDP sources are built once per box and weights variant instead: the C
# entries' suffix (kernels.backward.variant_key; nvcc's -DQILQR_VARIANT) ->
# (-DQILQR_BOX, -DQILQR_WEIGHTS). Each object holds its variant's kernels
# with and without exact DDP, in both dtypes, so that the sixteen kernels of
# a source compile in four nvcc processes side by side.
VARIANTS = {"": (0, 0), "_box": (1, 0), "_weights": (0, 1), "_box_weights": (1, 1)}
VARIANT_SOURCES = ("fddp", "stream_fddp")
# The objects of a source's penalty variant (the augmented-Lagrangian
# operands, csrc/backward.cu's kPen instantiations with and without the
# weights, quadrotor only): the object's stem and C entries' name -> (source,
# nvcc's define). An object of its own compiles beside the others, where
# four more kernels in the quadrotor's backward object would lengthen the
# longest of them.
PENALTY = {"backward_pen": ("backward", "-DQILQR_PEN=1")}
# the kernels built on csrc/team.cuh (every kernel, family, variant and
# penalty object), each with a qilqr_<name>_team_info entry
TEAM_KERNELS = tuple(f"{k}{fam}" for k in FAMILY_SOURCES for fam in FAMILIES) + tuple(
    f"{k}{var}" for k in VARIANT_SOURCES for var in VARIANTS
) + tuple(PENALTY)
ENTRIES = tuple(f"qilqr_{name}" for name in TEAM_KERNELS)


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


def _objects():
    """(source, defines, object stem) of every object the library links."""
    out = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        if src.stem in VARIANT_SOURCES:
            out += [(src, [f"-DQILQR_VARIANT={var}", f"-DQILQR_BOX={box}",
                           f"-DQILQR_WEIGHTS={w}"] if var else [], f"{src.stem}{var}")
                    for var, (box, w) in VARIANTS.items()]
            continue
        families = FAMILIES.items() if src.stem in FAMILY_SOURCES else (("", ""),)
        out += [(src, [f"-DQILQR_FAMILY_T={t}", f"-DQILQR_FAMILY={fam}"] if fam else [],
                 f"{src.stem}{fam}") for fam, t in families]
        out += [(src, [define], stem) for stem, (base, define) in PENALTY.items()
                if base == src.stem]
    return out


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(FAMILIES.items())).encode())
    h.update(repr(sorted(VARIANTS.items())).encode())
    h.update(repr(sorted(PENALTY.items())).encode())
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
        for src, defines, stem in _objects():
            obj = BUILD_DIR / f"{stem}_{os.getpid()}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *defines, "-c", str(src), "-o", str(obj)],
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

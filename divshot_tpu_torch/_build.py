"""Build and load the port's CUDA kernels.

One ``nvcc`` process a source, all started together, compiles every
``csrc/*.cu`` to an object; one more links them into one shared library
with a plain C interface (``csrc/api.h``) under ``build/divshot_tpu_torch/``
at the repository root; ``ctypes`` loads it. The library's file name carries a
hash of the sources and flags, so a changed source builds anew and an
unchanged one is reused. The build happens at first use, never at import.

``build_native`` compiles the host library (``native/*.cpp``: the COLMAP
parsers, Morton codes, PLY packing and the JPEG decoder) with one ``g++``
into the same directory, its name also carrying a hash of its sources and
flags; ``core/native.py`` loads it. It needs no CUDA.

``LAUNCHES`` counts kernel launches by name. Each wrapper adds one where it
launches its kernel and nowhere else, so a caller can zero the counts, run
a path, and see which kernels that path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "divshot_tpu_torch"
# -Xptxas -v: each kernel's registers, shared memory and spills, kept
# beside the library (``ptxas_report``)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

NATIVE_SRC = Path(__file__).resolve().parent / "native"
# the JAX package's flags for its host library (divshot_tpu/core/native.py)
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++20", "-pthread"]

LAUNCHES = {"expand": 0, "forward": 0, "backward": 0, "surfel_forward": 0,
            "surfel_backward": 0, "segment_rows": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_SIGNATURES = {
    "divshot_expand": [_P] * 9 + [_I32] * 5 + [_P, _P, _P],
    "divshot_expand_partition": [_P, _P, _I32, _I32, _I32, _P, _P],
    "divshot_forward": [_P, ctypes.c_int64, _P, _I32, _I32, _I32, _I32,
                        ctypes.c_float, _P, _P, _P],
    "divshot_backward": [_P, ctypes.c_int64, _P, _I32, _I32, _I32, _I32,
                         ctypes.c_float, _I32, _P, _P, _P, _P],
    "divshot_surfel_forward": [_P, ctypes.c_int64, _P, _I32, _I32, _I32,
                               _I32, ctypes.c_float, _P, _P, _P],
    "divshot_surfel_backward": [_P, ctypes.c_int64, _P, _I32, _I32, _I32,
                                _I32, ctypes.c_float, _P, _P, _P, _P],
    "divshot_backward_schedule": [_P, _I32, ctypes.c_int64, ctypes.c_int64,
                                  _P, _P],
    "divshot_segment_stage": [_P, ctypes.c_int64, _I32, _I32, _I32, _P,
                              _I32, _P, _P, _P, _I32, _P, _I32, _P],
    "divshot_segment_reduce": [_P, _I32, _I32, _P, _P, _I32, ctypes.c_int64,
                               _P, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME)")


def _sources() -> list[Path]:
    return (sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.h"))
            + sorted(CSRC.glob("*.cuh")))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdivshot_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if its sources changed -> (path, seconds spent
    compiling, 0 when it was already built)."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = BUILD_DIR / f"{so.stem}.{os.getpid()}.obj"
    objs.mkdir()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([_nvcc(), *compile_flags, "-c", "-o",
                          str(objs / f"{src.stem}.o"), str(src)]
                         for src in sorted(CSRC.glob("*.cu")))]
    report = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        report.append(err)
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{err}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *sorted(str(o) for o in objs.glob("*.o"))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stderr}")
    shutil.rmtree(objs)
    so.with_suffix(".ptxas.txt").write_text("".join(report))
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


def native_library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in sorted(NATIVE_SRC.glob("*.cpp")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdivshot_native_{h.hexdigest()[:16]}.so"


def build_native() -> tuple[Path, float]:
    """Compile the host library with ``g++`` if its sources changed ->
    (path, seconds spent compiling, 0 when it was already built). Raises
    ``RuntimeError`` when the compiler fails or is missing."""
    so = native_library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS,
           *(str(p) for p in sorted(NATIVE_SRC.glob("*.cpp"))),
           "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"g++ not found: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


def ptxas_report(so: Path) -> list[str]:
    """Per kernel of the library ``so``, from the ``-Xptxas -v`` output of
    its build: registers, static shared memory, stack and spills."""
    out, name = [], None
    path = so.with_suffix(".ptxas.txt")
    for line in (path.read_text().splitlines() if path.exists() else []):
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int, count: bool = True) -> None:
    """Raise on a non-zero cudaError_t, else count the launch (unless
    ``count`` is False: one launch of a kernel whose wrapper counts its
    launches together)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
    if count:
        LAUNCHES[name] += 1


def stream_ptr(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as a pointer (the raw handle:
    building a ``torch.cuda.Stream`` object costs a few microseconds a
    launch)."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if device.index is None
        else device.index)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            device: torch.device | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` / ``device`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")

"""Build and bind the port's hand-written CUDA kernels.

The sources under `cmvs_pmvs_tpu_torch/csrc/` are compiled at first use
with nvcc for sm_90a into one shared library with a plain C interface
(`build/torch_kernels/` at the repository root, named by a hash of the
sources so an edited kernel rebuilds), and loaded with ctypes. Nothing
here runs at import time: a CPU-only host imports the package without
nvcc.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("fan2.cu", "windows.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = 0.0   # wall time of the last nvcc build (0 if cached)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cmvs_fan_incc": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cmvs_windows": [_P, _I, _I, _I, _P, _P, _P, _P, _P, ctypes.c_longlong,
                     _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + ("common.cuh",):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcmvs_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the hashed library is missing; returns its
    path and records the build time in `build_seconds`."""
    global build_seconds
    path = library_path()
    if path.exists():
        build_seconds = 0.0
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(CSRC / s) for s in SOURCES]]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    build_seconds = time.time() - t0
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape, device):
    """Validate a kernel argument; raise on anything the kernel does not
    take."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")

"""Build and bind the port's hand-written CUDA kernels.

The sources under `cmvs_pmvs_tpu_torch/csrc/` are compiled at first use
with nvcc for sm_90a - one nvcc process per source, all started
together, then one link - into one shared library with a plain C
interface (`build/torch_kernels/` at the repository root, named by a
hash of the sources so an edited kernel rebuilds), and loaded with
ctypes. Nothing here runs at import time: a CPU-only host imports the
package without nvcc.
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
SOURCES = ("fan2.cu", "fan.cu", "incc.cu", "windows.cu", "ablate.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: ptxas reports each kernel's registers and spills
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC")

_lib = None
build_seconds = 0.0   # wall time of the last nvcc build (0 if cached)
build_report = ""     # nvcc's output of the library's build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cmvs_fan_incc": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cmvs_fan_v1_incc": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P],
    "cmvs_incc_blocks": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P],
    "cmvs_windows": [_P, _I, _I, _I, _P, _P, _P, _P, _P, ctypes.c_longlong,
                     _I, _I, _P],
    "cmvs_fan_abl": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cmvs_interp_abl": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                        *[ctypes.c_uint, _I] * 4, _I, _I, _I, _I, _P],
    "cmvs_moments_abl": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _P],
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
    path and records the build time in `build_seconds` and nvcc's output
    in `build_report` (kept beside the library, read back when cached)."""
    global build_seconds, build_report
    path = library_path()
    report = path.with_suffix(".txt")
    if path.exists():
        build_seconds = 0.0
        build_report = report.read_text() if report.exists() else ""
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    tmp = BUILD_DIR / f"{tag}.tmp"
    nvcc = _nvcc()
    t0 = time.time()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o",
                          str(o)] for s, o in zip(SOURCES, objs))]
    done = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in procs]
    failed = [d for d in done if d[2] != 0]
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            failed = [(cmd, proc.stdout, proc.returncode)]
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"({rc}) {' '.join(cmd)}\n{out}" for cmd, out, rc in failed))
    build_report = "".join(out for _, out, _ in done)
    report.write_text(build_report)
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

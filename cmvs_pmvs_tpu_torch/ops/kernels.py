"""Build and bind the port's hand-written CUDA kernels.

The sources under `cmvs_pmvs_tpu_torch/csrc/` are compiled at first use
with nvcc for sm_90a - one nvcc process per source, all started
together, then one link - into one shared library with a plain C
interface (`build/torch_kernels/`, named by a hash of the sources so an
edited kernel rebuilds; `utils/native`), and loaded with ctypes. Nothing
here runs at import time: a CPU-only host imports the package without
nvcc.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from ..utils import native

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = native.BUILD_ROOT / "torch_kernels"
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
_FAN = [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_FAN_V1 = [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_INCC = [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_WINDOWS = [_P, _I, _I, _I, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I,
            _P]
# K1-K4 are built for uint8 and float32 (gamma-decoded) atlases, K2 and K4
# also with the unblocked sampling rule (csrc/common.cuh): one symbol each.
_SIGNATURES = {
    "cmvs_fan_incc": _FAN, "cmvs_fan_incc_f32": _FAN,
    "cmvs_fan_v1_incc": _FAN_V1, "cmvs_fan_v1_incc_f32": _FAN_V1,
    "cmvs_incc_blocks": _INCC, "cmvs_incc_blocks_f32": _INCC,
    "cmvs_incc_blocks_unblocked": _INCC,
    "cmvs_incc_blocks_unblocked_f32": _INCC,
    "cmvs_windows": _WINDOWS, "cmvs_windows_f32": _WINDOWS,
    "cmvs_windows_unblocked": _WINDOWS, "cmvs_windows_unblocked_f32": _WINDOWS,
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
    return native.library_path(
        BUILD_DIR, "libcmvs_kernels",
        [CSRC / name for name in SOURCES + ("common.cuh",)], NVCC_FLAGS)


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
    tmp = native.staging(path)
    objs = [tmp.with_name(f"{tmp.stem}.{Path(s).stem}.o") for s in SOURCES]
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
        _lib = native.bind(build(), _SIGNATURES)
    return _lib


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


# Every Entry by name, in the order their wrapper modules made them (the
# K1-K4 wrappers, ops/fan2, ops/fan, ops/windows and ops/incc, each make
# theirs when imported).
ENTRIES: dict = {}
# While a CUDA graph is captured (`recording`): the launches it holds, by
# Entry; None otherwise.
_held: dict | None = None


@contextmanager
def recording():
    """Count the launches made inside the block into the yielded dict
    (Entry -> launches) instead of `Entry.launches`: a stream that
    captures a CUDA graph runs nothing, so what the graph holds counts
    when it replays (`replayed`)."""
    global _held
    if _held is not None:
        raise RuntimeError("kernels.recording: a graph is already being "
                           "captured")
    _held = {}
    try:
        yield _held
    finally:
        _held = None


def replayed(held: dict):
    """Count one replay of a graph holding `held` (Entry -> launches, from
    `recording`)."""
    for entry, n in held.items():
        entry.launches += n


class Entry:
    """One instantiation of a kernel in the library: its name (e.g.
    "windows_unblocked_f32"), its C symbol, its count of CUDA launches and
    an opt-in list (`capture`, None by default) that keeps every launch's
    wrapper arguments (args, kwargs) - the tensors, not copies - so that a
    run's launches can be replayed and timed at their own shapes
    (chip_smoke.py). Each registers itself in ENTRIES."""

    def __init__(self, name: str, symbol: str):
        self.name = name
        self.symbol = symbol
        self.launches = 0
        self.capture = None
        ENTRIES[name] = self

    def launch(self, c_args: tuple, args: tuple, kwargs: dict):
        """Launch on the current stream with the C arguments `c_args`
        (the stream appended), then `tally` it; raise on a launch
        error."""
        check(getattr(lib(), self.symbol)(*c_args, stream_handle()),
              self.name)
        self.tally(args, kwargs)

    def tally(self, args: tuple = (), kwargs: dict | None = None):
        """Count one launch and keep (args, kwargs) where capturing; while
        a CUDA graph is captured (`recording`), count it into the graph's
        tally instead. The capture list keeps the launch's tensors, which
        a graph overwrites on every replay: it raises there."""
        if _held is not None:
            if self.capture is not None:
                raise RuntimeError(f"{self.name}: its launch capture list "
                                   f"is set while a CUDA graph is "
                                   f"captured; run with graphs=False")
            _held[self] = _held.get(self, 0) + 1
            return
        self.launches += 1
        if self.capture is not None:
            self.capture.append((args, kwargs or {}))


def entries() -> dict:
    """Every K1-K4 instantiation's Entry by name, once the four wrapper
    modules that make them are imported."""
    from . import fan, fan2, incc, windows  # noqa: F401 (their Entries)
    return dict(ENTRIES)


def launch_counts() -> dict:
    """A snapshot of every K1-K4 instantiation's launch count by name. Code
    that counts the launches of a stretch of work takes the difference of
    two snapshots (`launches_since`) and leaves the counters alone, so a
    caller counting around it still reads every launch."""
    return {k: e.launches for k, e in entries().items()}


def launches_since(before: dict) -> dict:
    """The launches of each instantiation since the snapshot `before`
    (`launch_counts()`), those that launched only."""
    return {k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n - before.get(k, 0)}


def entry_for(entries: dict, key, name: str) -> Entry:
    """The instantiation of `entries` for `key` (an atlas dtype, or (dtype,
    blocked)); raise on a key the kernel is not built for."""
    if key not in entries:
        raise TypeError(f"{name}: no kernel for {key}; built for "
                        f"{sorted(map(str, entries))}")
    return entries[key]


def require_atlas(atlas: torch.Tensor, device):
    """Validate a kernel's atlas [N, H, WA, 3], uint8 or float32; returns
    (N, H, WA)."""
    if atlas.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"atlas: dtype {atlas.dtype}, the kernels take "
                        f"torch.uint8 or torch.float32")
    if atlas.dim() != 4 or atlas.shape[3] != 3:
        raise ValueError(f"atlas: shape {tuple(atlas.shape)}, expected "
                         f"[N, H, WA, 3]")
    n, h, wa, _ = atlas.shape
    require(atlas, "atlas", atlas.dtype, (n, h, wa, 3), device)
    return n, h, wa


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

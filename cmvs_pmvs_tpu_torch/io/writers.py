"""Build and bind the host C++ writers of the cloud files
(`cmvs_pmvs_tpu_torch/csrc/writers.cpp`): `.patch`, `.ply` and `.pset`.

The source is compiled at first use with the host C++ compiler into a
shared library with a plain C interface (`build/torch_writers/`, named
by a hash of the source and the flags, built and loaded as the CUDA
kernels are: `utils/native`). Nothing here runs at import time.

The functions take the arrays as the C side reads them; `io/patches` and
`io/ply` prepare them.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..utils import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "writers.cpp"
BUILD_DIR = native.BUILD_ROOT / "torch_writers"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")

_lib = None

_S = ctypes.c_char_p
_P = ctypes.c_void_p
_L = ctypes.c_int64
_SIGNATURES = {
    "cmvs_write_patch": [_S, _P, _P, _L, _P, _L, _L],
    "cmvs_write_ply": [_S, _S, _P, _P, _P, _L],
    "cmvs_write_pset": [_S, _P, _L],
}


def _cxx() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler found: the cloud writers "
                       "(csrc/writers.cpp) need c++ or g++ on PATH")


def library_path() -> Path:
    return native.library_path(BUILD_DIR, "libcmvs_writers", [SOURCE],
                               CXX_FLAGS)


def build() -> Path:
    """Compile the writers if the hashed library is missing; returns its
    path."""
    path = library_path()
    if path.exists():
        return path
    tmp = native.staging(path)
    proc = subprocess.run([_cxx(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"C++ compile of {SOURCE} failed "
                           f"({proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded writer library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = native.bind(build(), _SIGNATURES)
    return _lib


def _rows(a, dtype, shape: tuple, name: str) -> np.ndarray:
    """`a` as a C-contiguous array of `dtype` and `shape` (None: any
    length on that axis); raises on another shape."""
    a = np.ascontiguousarray(a, dtype)
    if a.ndim != len(shape) or any(s is not None and s != d
                                   for s, d in zip(shape, a.shape)):
        raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
    return a


def _check(rc: int, path):
    if rc != 0:
        raise OSError(rc, os.strerror(rc), os.fspath(path))


def write_patch(path, heads, images, vimages) -> None:
    """The .patch file: heads float64 [P, 11] (coord, normal, ncc, dscale,
    ascale), images / vimages int64 [P, K] ids (negative ones left out)."""
    heads = _rows(heads, np.float64, (None, 11), "heads")
    n = len(heads)
    images = _rows(images, np.int64, (n, None), "images")
    vimages = _rows(vimages, np.int64, (n, None), "vimages")
    _check(lib().cmvs_write_patch(
        os.fsencode(path), heads.ctypes.data, images.ctypes.data,
        images.shape[1], vimages.ctypes.data, vimages.shape[1], n), path)


def write_ply(path, header: str, xyzn, colors, quality) -> None:
    """The .ply file: `header`, then per row xyzn float64 [P, 6], colors
    int64 [P, 3], quality float64 [P]."""
    xyzn = _rows(xyzn, np.float64, (None, 6), "xyzn")
    n = len(xyzn)
    colors = _rows(colors, np.int64, (n, 3), "colors")
    quality = _rows(quality, np.float64, (n,), "quality")
    _check(lib().cmvs_write_ply(
        os.fsencode(path), header.encode("ascii"), xyzn.ctypes.data,
        colors.ctypes.data, quality.ctypes.data, n), path)


def write_pset(path, xyzn) -> None:
    """The .pset file: xyzn float64 [P, 6] (x y z nx ny nz) a line."""
    xyzn = _rows(xyzn, np.float64, (None, 6), "xyzn")
    _check(lib().cmvs_write_pset(os.fsencode(path), xyzn.ctypes.data,
                                 len(xyzn)), path)

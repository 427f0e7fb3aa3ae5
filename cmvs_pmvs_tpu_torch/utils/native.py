"""The build steps shared by the port's compiled libraries: the CUDA
kernels (`ops/kernels`) and the host C++ cloud writers (`io/writers`).

A library is named by a hash of its sources and flags, so an edited
source rebuilds; it is compiled to a file tagged with the process id and
renamed into place, so concurrent `pmvs3_all` workers and torchrun ranks
do not collide; it is loaded with ctypes and its C functions bound to
their argument types. Libraries live under `build/` at the repository
root in a checkout, and under the user's cache directory when the
package is installed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
BUILD_ROOT = (_ROOT / "build" if (_ROOT / "pyproject.toml").exists()
              else Path.home() / ".cache" / "cmvs_pmvs_tpu_torch")


def library_path(build_dir: Path, stem: str, sources, flags) -> Path:
    """`<build_dir>/<stem>_<hash>.so`, the hash over the sources' bytes and
    the flags."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(" ".join(flags).encode())
    return Path(build_dir) / f"{stem}_{h.hexdigest()[:16]}.so"


def staging(path: Path) -> Path:
    """A pid-tagged temporary name beside `path` (its directory made) to
    compile into before `os.replace(staging(path), path)`."""
    path.parent.mkdir(parents=True, exist_ok=True)
    return path.parent / f"{path.stem}.{os.getpid()}.tmp"


def bind(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load the library at `path`; each named C function takes the listed
    ctypes argument types and returns an int status."""
    handle = ctypes.CDLL(str(path))
    for name, args in signatures.items():
        fn = getattr(handle, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return handle

"""Occupancy sweep of K5 and K7 (the fan-ablation kernels) on the GPU.

On the inputs of ablate_fan and ablate_fan25 (B = 8192 patches, T = 6
views, fan 4, wsize 7), it times every mode of K5 and K7 with each block
padded with unused dynamic shared memory, so that at most 4, 3, 2 and 1
blocks fit an SM, beside the kernels' own launch (first and last, to
show drift), and prints the warps an SM holds at each setting (the CUDA
occupancy calculator's count). A mode whose time falls as warps are
added waits on latency that they hide; one whose time stays runs at
issue rate. The kernels are the library's own: csrc/ablate_occupancy.cu
includes csrc/ablate.cu and adds only the padded launches; it is built
into build/torch_kernels/ apart from the kernel library. Times are
device ms (`ablate_common.time_ms`).

    python -m cmvs_pmvs_tpu_torch.scripts.ablate_occupancy

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from ..device import resolve_device
from ..ops import kernels
from ..ops.ablate import FAN_ABL_MODES, MOMENTS_ABL_MODES, moments_abl_lead
from ..utils import native
from . import ablate_common as C
from . import ablate_fan25 as D7
from .ablate_fan import FAN, make_inputs

SOURCE = "ablate_occupancy.cu"
CAPS = (0, 4, 3, 2, 1, 0)   # at most this many blocks an SM; 0: unpadded

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "cmvs_occ_fan_abl": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _IP, _P],
    "cmvs_occ_moments_abl": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _IP, _P],
}


def build() -> ctypes.CDLL:
    """The library of csrc/ablate_occupancy.cu (with ablate.cu and
    common.cuh, under the kernel library's nvcc flags), compiled into
    build/torch_kernels/ unless these sources' build is there, loaded."""
    path = native.library_path(
        kernels.BUILD_DIR, "libcmvs_occupancy",
        [kernels.CSRC / name for name in (SOURCE, "ablate.cu", "common.cuh")],
        kernels.NVCC_FLAGS)
    if not path.exists():
        tmp = native.staging(path)
        proc = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(tmp),
             str(kernels.CSRC / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, path)
    return native.bind(path, SIGNATURES)


def sweep(lib, i5: dict, i7: dict, log=print) -> dict:
    """Time every mode of K5 and K7 at each of CAPS on the device tensors
    `i5` (ablate_fan's inputs) and `i7` (ablate_fan25's); returns
    {(kernel, mode, i): (warps an SM, min ms, median ms)} for CAPS[i]."""
    n, h, wa, _ = i5["atlas"].shape
    b, t = i5["tilemap"].shape
    # large enough for every mode's output
    out = torch.empty((b, t, FAN, 9), dtype=torch.float32,
                      device=i5["atlas"].device)
    warps = ctypes.c_int()

    def k5(mode, cap):
        return lib.cmvs_occ_fan_abl(
            i5["atlas"].data_ptr(), n, h, wa, i5["tilemap"].data_ptr(),
            i5["geom"].data_ptr(), out.data_ptr(), b, t, FAN, C.WSIZE,
            FAN_ABL_MODES.index(mode), cap, ctypes.byref(warps),
            kernels.stream_handle())

    def k7(mode, cap):
        return lib.cmvs_occ_moments_abl(
            i7["atlas"].data_ptr(), n, h, wa, i7["tilemap"].data_ptr(),
            i7[f"frames{FAN}"].data_ptr(), out.data_ptr(), b, t, FAN,
            C.WSIZE, D7.PPV, moments_abl_lead(FAN),
            MOMENTS_ABL_MODES.index(mode), cap, ctypes.byref(warps),
            kernels.stream_handle())

    cases = ([("K5", m, k5) for m in FAN_ABL_MODES]
             + [("K7", m, k7) for m in MOMENTS_ABL_MODES])
    res = {}
    for i, cap in enumerate(CAPS):
        setting = f"<= {cap} blocks/SM" if cap else "own launch"
        for name, mode, launch in cases:
            def call():
                kernels.check(launch(mode, cap), f"{name} {mode}")
            t_min, t_med = C.time_ms(call, samples=6)
            res[name, mode, i] = (warps.value, t_min, t_med)
            log(f"{setting:16s} {name} {mode:12s} {warps.value:3d} warps/SM "
                f"{t_min:9.4f} ms (median {t_med:9.4f})")
    return res


def main(argv=None) -> int:
    argparse.ArgumentParser(
        description=__doc__.splitlines()[0]).parse_args(argv)
    dev = resolve_device()
    print(f"card: {C.card()}", flush=True)
    sweep(build(), C.to_device(make_inputs(), dev),
          C.to_device(D7.make_inputs(), dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

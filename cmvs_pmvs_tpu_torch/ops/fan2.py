"""Refine-fan robust INCC (v2): kernel K1 and its plain twin.

Counterpart of cmvs_pmvs_tpu/ops/pallas_fan2.py (`incc_fan2`,
`fan_geometry2`, `_moments_tail2`). The LM fan path
(ops/refine._refine_patches_fan) evaluates, for every (patch, view) pair
and every probe of the fan, the robust INCC of the view's window against
the reference view's window; `incc_fan` is that evaluation, on frames
from the shared front end `ops/fan.grab_frames`. Unlike v1 (ops/fan,
K3) it samples each probe straight from the atlas, with no tile.

`incc_fan` launches the CUDA kernel (csrc/fan2.cu) for CUDA tensors and
runs `incc_fan_plain` for CPU tensors. The kernel computes in float32
throughout; the reference's `precise` switch (bf16 rounding in its fast
mode) has no counterpart and is not accepted.
"""
from __future__ import annotations

import torch

from ..image.sample import bilinear_at
from . import kernels
from .fan import check_fan_shape, robust_incc_vs_ref, window_positions


def incc_fan_plain(atlas_u8, vid, frames, ok, wsize: int):
    """Plain PyTorch version of the K1 kernel, same signature:
    atlas_u8 [N, H, WA, 3] u8, vid [B, T] i32, frames [B, T, fan, 6]
    f32, ok [B, T, fan] bool -> incc [B, T, fan] f32 (unmasked; callers
    apply validity)."""
    x, y = window_positions(frames, wsize)                  # [B,T,F,S2]
    n = vid.long().clamp(0, atlas_u8.shape[0] - 1)[:, :, None, None]
    return robust_incc_vs_ref(bilinear_at(atlas_u8, n, x, y), ok)


def incc_fan(atlas_u8, vid, frames, ok, wsize: int):
    """Robust INCC of every (patch, view, probe) vs the patch's view-0
    window at the same probe; K1 on CUDA tensors, `incc_fan_plain` on CPU
    tensors. Shapes as in `incc_fan_plain`."""
    if not frames.is_cuda:
        return incc_fan_plain(atlas_u8, vid, frames, ok, wsize)
    b, t, fan, _ = frames.shape
    dev = frames.device
    check_fan_shape("incc_fan", t, wsize)
    n, h, wa, _ = atlas_u8.shape
    kernels.require(atlas_u8, "atlas_u8", torch.uint8, (n, h, wa, 3), dev)
    kernels.require(vid, "vid", torch.int32, (b, t), dev)
    kernels.require(frames, "frames", torch.float32, (b, t, fan, 6), dev)
    kernels.require(ok, "ok", torch.bool, (b, t, fan), dev)
    out = torch.empty((b, t, fan), dtype=torch.float32, device=dev)
    if b * fan == 0:
        return out
    lib = kernels.lib()
    kernels.check(lib.cmvs_fan_incc(
        atlas_u8.data_ptr(), n, h, wa, vid.data_ptr(), frames.data_ptr(),
        ok.data_ptr(), out.data_ptr(), b, t, fan, wsize,
        kernels.stream_handle()), "incc_fan")
    incc_fan.launches += 1
    if incc_fan.capture is not None:
        incc_fan.capture.append(((atlas_u8, vid, frames, ok, wsize), {}))
    return out


incc_fan.launches = 0
# Opt-in: a list that keeps every launch's arguments (see
# ops/fan.incc_fan_v1.capture).
incc_fan.capture = None

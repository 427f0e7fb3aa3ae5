"""Refine-fan robust INCC (v2): kernel K1 and its plain twin.

Counterpart of cmvs_pmvs_tpu/ops/pallas_fan2.py (`incc_fan2`,
`fan_geometry2`, `_moments_tail2`). The LM fan path
(ops/refine._refine_patches_fan) evaluates, for every (patch, view) pair
and every probe of the fan, the robust INCC of the view's window against
the reference view's window; `incc_fan` is that evaluation, on frames
from the shared front end `ops/fan.grab_frames`. Unlike v1 (ops/fan,
K3) it samples each probe straight from the atlas, with no tile.

`incc_fan` launches the CUDA kernel (csrc/fan2.cu) for CUDA tensors -
its uint8 instantiation on a byte atlas, its float32 one on a
gamma-decoded atlas - and runs `incc_fan_plain` for CPU tensors. The
kernel computes in float32 throughout; the reference's `precise` switch
(bf16 rounding in its fast mode) has no counterpart and is not
accepted.
"""
from __future__ import annotations

import torch

from ..image.sample import bilinear_at
from . import kernels
from .fan import check_fan_shape, robust_incc_vs_ref, window_positions


def incc_fan_plain(atlas, vid, frames, ok, wsize: int):
    """Plain PyTorch version of the K1 kernel, same signature:
    atlas [N, H, WA, 3] u8 or f32 (gamma-decoded), vid [B, T] i32, frames
    [B, T, fan, 6] f32, ok [B, T, fan] bool -> incc [B, T, fan] f32
    (unmasked; callers apply validity)."""
    x, y = window_positions(frames, wsize)                  # [B,T,F,S2]
    n = vid.long().clamp(0, atlas.shape[0] - 1)[:, :, None, None]
    return robust_incc_vs_ref(bilinear_at(atlas, n, x, y), ok)


def incc_fan(atlas, vid, frames, ok, wsize: int):
    """Robust INCC of every (patch, view, probe) vs the patch's view-0
    window at the same probe; K1 on CUDA tensors (the instantiation for the
    atlas's dtype, uint8 or float32), `incc_fan_plain` on CPU tensors.
    Shapes as in `incc_fan_plain`."""
    if not frames.is_cuda:
        return incc_fan_plain(atlas, vid, frames, ok, wsize)
    b, t, fan, _ = frames.shape
    dev = frames.device
    check_fan_shape("incc_fan", t, wsize)
    n, h, wa = kernels.require_atlas(atlas, dev)
    entry = kernels.entry_for(incc_fan.entries, atlas.dtype, "incc_fan")
    kernels.require(vid, "vid", torch.int32, (b, t), dev)
    kernels.require(frames, "frames", torch.float32, (b, t, fan, 6), dev)
    kernels.require(ok, "ok", torch.bool, (b, t, fan), dev)
    out = torch.empty((b, t, fan), dtype=torch.float32, device=dev)
    if b * fan == 0:
        return out
    entry.launch((atlas.data_ptr(), n, h, wa, vid.data_ptr(),
                  frames.data_ptr(), ok.data_ptr(), out.data_ptr(), b, t, fan,
                  wsize), (atlas, vid, frames, ok, wsize), {})
    return out


# One instantiation an atlas dtype, each with its launch count and capture
# list (kernels.Entry).
incc_fan.entries = {
    torch.uint8: kernels.Entry("incc_fan", "cmvs_fan_incc"),
    torch.float32: kernels.Entry("incc_fan_f32", "cmvs_fan_incc_f32")}

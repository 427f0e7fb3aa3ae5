"""Fused block INCC: kernel K4 and its plain twin.

Counterpart of cmvs_pmvs_tpu/ops/pallas_incc.incc_pallas and
`incc_pallas_regions` (one function; the regions variant is only a way
of re-using fetched TPU blocks across an m-fold probe batch, which the
GPU kernel, reading taps straight from the atlas, does not need). The
objective of the central-difference LM (ops/refine.per_view_inccs off
the fan path) is grab + normalize + robust INCC against view 0 for every
(patch, view) pair; `incc_blocks` is that evaluation on the block
geometry of `texture.grab_block_geometry`.

`incc_blocks` launches the CUDA kernel (csrc/incc.cu) for CUDA tensors
and runs `incc_blocks_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from . import kernels
from .texture import BLOCK_K, ncc_dot, robustincc
from .windows import check_block_shape, windows_plain


def incc_blocks_plain(atlas_u8, starts, relx, rely, ok, t: int,
                      k: int = BLOCK_K):
    """Plain PyTorch version of the K4 kernel: the K2 windows of every
    pair, their dot with view 0's window, the robust INCC.

    atlas_u8 [N, H, WA, 3] u8; starts [B*T, 3] i32 (n, sy, sx_atlas);
    relx/rely [B*T, S2] block-relative positions; ok [B*T] bool.
    Returns [B, T] f32: 2.0 where the pair's or the reference's grab
    failed; the reference slot 0.0 when its grab succeeded, else 2.0
    (pallas_incc.py:67-78)."""
    tex = windows_plain(atlas_u8, starts, relx, rely, ok, t, k)
    incc = robustincc(1.0 - ncc_dot(tex[:, 0:1], tex))
    okb = ok.reshape(-1, t)
    ref_ok = okb[:, 0:1]
    incc = torch.where(ref_ok & okb, incc, torch.full_like(incc, 2.0))
    incc[:, 0] = torch.where(ref_ok[:, 0], 0.0, 2.0)
    return incc


def incc_blocks(atlas_u8, starts, relx, rely, ok, t: int, k: int = BLOCK_K):
    """Robust INCC of every (patch, view) window vs the patch's view-0
    window -> [B, T]; K4 on CUDA tensors, `incc_blocks_plain` on CPU
    tensors. Shapes and conventions as in `incc_blocks_plain`."""
    if not relx.is_cuda:
        return incc_blocks_plain(atlas_u8, starts, relx, rely, ok, t, k)
    bt, s2 = relx.shape
    dev = relx.device
    check_block_shape("incc_blocks", bt, t, s2, k, max_t=32)
    n, h, wa, _ = atlas_u8.shape
    kernels.require(atlas_u8, "atlas_u8", torch.uint8, (n, h, wa, 3), dev)
    kernels.require(starts, "starts", torch.int32, (bt, 3), dev)
    kernels.require(relx, "relx", torch.float32, (bt, s2), dev)
    kernels.require(rely, "rely", torch.float32, (bt, s2), dev)
    kernels.require(ok, "ok", torch.bool, (bt,), dev)
    out = torch.empty((bt // t, t), dtype=torch.float32, device=dev)
    if bt == 0:
        return out
    lib = kernels.lib()
    kernels.check(lib.cmvs_incc_blocks(
        atlas_u8.data_ptr(), n, h, wa, starts.data_ptr(), relx.data_ptr(),
        rely.data_ptr(), ok.data_ptr(), out.data_ptr(), bt // t, t, s2, k,
        kernels.stream_handle()), "incc_blocks")
    incc_blocks.launches += 1
    if incc_blocks.capture is not None:
        incc_blocks.capture.append(((atlas_u8, starts, relx, rely, ok),
                                    {"t": t, "k": k}))
    return out


incc_blocks.launches = 0
# Opt-in: a list that keeps every launch's arguments (see
# ops/fan.incc_fan_v1.capture).
incc_blocks.capture = None

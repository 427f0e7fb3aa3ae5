"""Normalized texture windows: kernel K2 and its plain twin.

Counterpart of cmvs_pmvs_tpu/ops/pallas_incc.windows_pallas (with its
XLA block gather `_gather_blocks`). The view-selection passes that need
pairwise NCCs - constraintImages in preProcess, the pairwise matrix of
postProcess and setRefImage in filterExact - take the normalized windows
of every (patch, view) pair of a mask from here (models/views.
grab_masked) and correlate them with one batched matmul.

`windows` launches the CUDA kernel (csrc/windows.cu) for CUDA tensors
and runs `windows_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from . import kernels
from .texture import BLOCK_K, block_bilinear, normalize_tex


def windows_plain(atlas_u8, starts, relx, rely, ok, t: int,
                  k: int = BLOCK_K):
    """Plain PyTorch version of the K2 kernel: grab_tex's block sampling
    + normalize_tex, laid out as the kernel's output.

    atlas_u8 [N, H, WA, 3] u8; starts [B*T, 3] i32 (n, sy, sx_atlas);
    relx/rely [B*T, S2] block-relative positions; ok [B*T] bool.
    Returns [B, T, S2, 3] f32, zeros where ok is False."""
    bt, s2 = relx.shape
    texs = block_bilinear(atlas_u8, starts[:, 0], starts[:, 1],
                          starts[:, 2], relx, rely, k)
    return normalize_tex(texs, ok).reshape(bt // t, t, s2, 3)


def windows(atlas_u8, starts, relx, rely, ok, t: int, k: int = BLOCK_K):
    """Normalized windows for [B*T] (patch, view) pairs -> [B, T, S2, 3];
    K2 on CUDA tensors, `windows_plain` on CPU tensors."""
    stats = windows.clip_stats
    if stats is not None:
        clipped = ((relx < 0.0) | (relx > k - 1.0) | (rely < 0.0)
                   | (rely > k - 1.0)).any(dim=1) & ok
        stats["pairs"] = stats.get("pairs", 0) + ok.sum()
        stats["clipped"] = stats.get("clipped", 0) + clipped.sum()
    if not relx.is_cuda:
        return windows_plain(atlas_u8, starts, relx, rely, ok, t, k)
    bt, s2 = relx.shape
    dev = relx.device
    if bt % t:
        raise ValueError(f"windows: {bt} pairs is not a multiple of T={t}")
    n, h, wa, _ = atlas_u8.shape
    kernels.require(atlas_u8, "atlas_u8", torch.uint8, (n, h, wa, 3), dev)
    kernels.require(starts, "starts", torch.int32, (bt, 3), dev)
    kernels.require(relx, "relx", torch.float32, (bt, s2), dev)
    kernels.require(rely, "rely", torch.float32, (bt, s2), dev)
    kernels.require(ok, "ok", torch.bool, (bt,), dev)
    out = torch.empty((bt // t, t, s2, 3), dtype=torch.float32, device=dev)
    if bt == 0:
        return out
    lib = kernels.lib()
    kernels.check(lib.cmvs_windows(
        atlas_u8.data_ptr(), n, h, wa, starts.data_ptr(), relx.data_ptr(),
        rely.data_ptr(), ok.data_ptr(), out.data_ptr(), bt, s2, k,
        kernels.stream_handle()), "windows")
    windows.launches += 1
    return out


windows.launches = 0
# Opt-in diagnostic: set to a dict to accumulate, as device scalars, the
# ok pairs ("pairs") and those with a bilinear tap outside the BLOCK_K
# block ("clipped") - the reference's block semantics drop such taps.
windows.clip_stats = None

"""Normalized texture windows: kernel K2 and its plain twin.

Counterpart of cmvs_pmvs_tpu/ops/pallas_incc.windows_pallas (with its
XLA block gather `_gather_blocks`). The view-selection passes that need
pairwise NCCs - constraintImages in preProcess, the pairwise matrix of
postProcess and setRefImage in filterExact - take the normalized windows
of every (patch, view) pair of a mask from here (models/views.
grab_masked) and correlate them with one batched matmul.

`windows` launches the CUDA kernel (csrc/windows.cu) for CUDA tensors -
one instantiation for each atlas dtype (uint8, float32 for gamma-decoded
pyramids) and sampling rule (blocked, the reference's default; unblocked,
its `_USE_BLOCK_SAMPLING = False`) - and runs `windows_plain` for CPU
tensors.
"""
from __future__ import annotations

import torch

from . import kernels
from .texture import BLOCK_K, block_bilinear, normalize_tex

# The largest window K2 and K4 take (csrc/common.cuh kBlockMaxWsize):
# s2 <= MAX_WSIZE ** 2 samples a window; the plain versions take any.
MAX_WSIZE = 63


def check_block_shape(name: str, pairs: int, t: int, s2: int, k: int,
                      max_t: int | None = None):
    """Raise on a batch the block kernels K2 and K4 do not take: pairs not
    a whole number of T-view patches (T >= 1, and <= max_t where given),
    s2 outside 1..MAX_WSIZE ** 2, a block of k < 1 px."""
    if t < 1 or (max_t is not None and t > max_t):
        raise ValueError(f"{name}: T={t} views, the kernel takes "
                         f"1..{max_t or 'any'}")
    if pairs % t:
        raise ValueError(f"{name}: {pairs} pairs is not a multiple of "
                         f"T={t}")
    if not 1 <= s2 <= MAX_WSIZE ** 2:
        raise ValueError(f"{name}: {s2} samples a window, the kernel takes "
                         f"1..{MAX_WSIZE ** 2} (wsize <= {MAX_WSIZE})")
    if k < 1:
        raise ValueError(f"{name}: block of k={k} px, the kernel takes "
                         f"k >= 1")


def block_entries(name: str, symbol: str) -> dict:
    """K2's or K4's four instantiations (kernels.Entry), keyed by (atlas
    dtype, blocked): uint8 or float32 atlas, blocked or unblocked rule."""
    return {(dtype, blocked): kernels.Entry(
        name + ("" if blocked else "_unblocked") + suffix,
        symbol + ("" if blocked else "_unblocked") + suffix)
        for dtype, suffix in ((torch.uint8, ""), (torch.float32, "_f32"))
        for blocked in (True, False)}


def windows_plain(atlas, starts, relx, rely, ok, t: int, k: int = BLOCK_K,
                  blocked: bool = True):
    """Plain PyTorch version of the K2 kernel: grab_tex's block sampling
    (blocked) or its unblocked bilinear sampling (texture.block_bilinear)
    + normalize_tex, laid out as the kernel's output.

    atlas [N, H, WA, 3] u8 or f32; starts [B*T, 3] i32 (n, sy, sx_atlas);
    relx/rely [B*T, S2] block-relative positions; ok [B*T] bool.
    Returns [B, T, S2, 3] f32, zeros where ok is False."""
    bt, s2 = relx.shape
    texs = block_bilinear(atlas, starts[:, 0], starts[:, 1], starts[:, 2],
                          relx, rely, k, blocked)
    return normalize_tex(texs, ok).reshape(bt // t, t, s2, 3)


def windows(atlas, starts, relx, rely, ok, t: int, k: int = BLOCK_K,
            blocked: bool = True):
    """Normalized windows for [B*T] (patch, view) pairs -> [B, T, S2, 3];
    K2 on CUDA tensors (the instantiation for the atlas's dtype and
    `blocked`), `windows_plain` on CPU tensors."""
    stats = windows.clip_stats
    if stats is not None and blocked:
        clipped = ((relx < 0.0) | (relx > k - 1.0) | (rely < 0.0)
                   | (rely > k - 1.0)).any(dim=1) & ok
        stats["pairs"] = stats.get("pairs", 0) + ok.sum()
        stats["clipped"] = stats.get("clipped", 0) + clipped.sum()
    if not relx.is_cuda:
        return windows_plain(atlas, starts, relx, rely, ok, t, k, blocked)
    bt, s2 = relx.shape
    dev = relx.device
    check_block_shape("windows", bt, t, s2, k)
    n, h, wa = kernels.require_atlas(atlas, dev)
    entry = kernels.entry_for(windows.entries, (atlas.dtype, blocked),
                              "windows")
    kernels.require(starts, "starts", torch.int32, (bt, 3), dev)
    kernels.require(relx, "relx", torch.float32, (bt, s2), dev)
    kernels.require(rely, "rely", torch.float32, (bt, s2), dev)
    kernels.require(ok, "ok", torch.bool, (bt,), dev)
    out = torch.empty((bt // t, t, s2, 3), dtype=torch.float32, device=dev)
    if bt == 0:
        return out
    entry.launch((atlas.data_ptr(), n, h, wa, starts.data_ptr(),
                  relx.data_ptr(), rely.data_ptr(), ok.data_ptr(),
                  out.data_ptr(), bt, s2, k),
                 (atlas, starts, relx, rely, ok),
                 {"t": t, "k": k, "blocked": blocked})
    return out


# The four instantiations, each with its launch count and capture list
# (kernels.Entry): windows, windows_f32, windows_unblocked,
# windows_unblocked_f32.
windows.entries = block_entries("windows", "cmvs_windows")
# Opt-in diagnostic: set to a dict to accumulate, as device scalars, the
# ok pairs ("pairs") and those with a bilinear tap outside the BLOCK_K
# block ("clipped") - the reference's block semantics drop such taps
# (counted for blocked calls only).
windows.clip_stats = None

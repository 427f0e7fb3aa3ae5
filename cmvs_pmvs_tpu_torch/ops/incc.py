"""Fused block INCC: kernel K4 and its plain twin.

K4 is the counterpart of the Pallas kernel `_incc_kernel`
(cmvs_pmvs_tpu/ops/pallas_incc.py, launched by `incc_pallas` and
`incc_pallas_regions`), but nothing in the reference package calls those
launchers: there the central-difference LM's objective (refine.
per_view_inccs off the kernel path) is `grab_tex` + `normalize_tex` +
`ncc_dot` in XLA (`_grab_all`). The port's central path (CPU tensors, or
refine.USE_FAN = False on CUDA) runs that objective as one kernel: grab +
normalize + robust INCC against view 0 for every (patch, view) pair, on
the block geometry of `texture.grab_block_geometry`. Bicubic sampling
has no kernel and stays in plain torch (ops/grab).

`incc_blocks` launches the CUDA kernel (csrc/incc.cu) for CUDA tensors -
one instantiation for each atlas dtype (uint8, float32) and sampling rule
(blocked, unblocked) - and runs `incc_blocks_plain` for CPU tensors.
"""
from __future__ import annotations

import torch

from . import kernels
from .texture import BLOCK_K, ncc_dot, robustincc
from .windows import block_entries, check_block_shape, windows_plain


def incc_blocks_plain(atlas, starts, relx, rely, ok, t: int,
                      k: int = BLOCK_K, blocked: bool = True):
    """Plain PyTorch version of the K4 kernel: the K2 windows of every
    pair, their dot with view 0's window, the robust INCC.

    atlas [N, H, WA, 3] u8 or f32; starts [B*T, 3] i32 (n, sy, sx_atlas);
    relx/rely [B*T, S2] block-relative positions; ok [B*T] bool; blocked
    as in windows_plain. Returns [B, T] f32: 2.0 where the pair's or the
    reference's grab failed; the reference slot 0.0 when its grab
    succeeded, else 2.0 (pallas_incc.py:67-78)."""
    tex = windows_plain(atlas, starts, relx, rely, ok, t, k, blocked)
    incc = robustincc(1.0 - ncc_dot(tex[:, 0:1], tex))
    okb = ok.reshape(-1, t)
    ref_ok = okb[:, 0:1]
    incc = torch.where(ref_ok & okb, incc, torch.full_like(incc, 2.0))
    incc[:, 0] = torch.where(ref_ok[:, 0], 0.0, 2.0)
    return incc


def incc_blocks(atlas, starts, relx, rely, ok, t: int, k: int = BLOCK_K,
                blocked: bool = True):
    """Robust INCC of every (patch, view) window vs the patch's view-0
    window -> [B, T]; K4 on CUDA tensors (the instantiation for the
    atlas's dtype and `blocked`), `incc_blocks_plain` on CPU tensors.
    Shapes and conventions as in `incc_blocks_plain`."""
    if not relx.is_cuda:
        return incc_blocks_plain(atlas, starts, relx, rely, ok, t, k,
                                 blocked)
    bt, s2 = relx.shape
    dev = relx.device
    check_block_shape("incc_blocks", bt, t, s2, k, max_t=32)
    n, h, wa = kernels.require_atlas(atlas, dev)
    entry = kernels.entry_for(incc_blocks.entries, (atlas.dtype, blocked),
                              "incc_blocks")
    kernels.require(starts, "starts", torch.int32, (bt, 3), dev)
    kernels.require(relx, "relx", torch.float32, (bt, s2), dev)
    kernels.require(rely, "rely", torch.float32, (bt, s2), dev)
    kernels.require(ok, "ok", torch.bool, (bt,), dev)
    out = torch.empty((bt // t, t), dtype=torch.float32, device=dev)
    if bt == 0:
        return out
    entry.launch((atlas.data_ptr(), n, h, wa, starts.data_ptr(),
                  relx.data_ptr(), rely.data_ptr(), ok.data_ptr(),
                  out.data_ptr(), bt // t, t, s2, k),
                 (atlas, starts, relx, rely, ok),
                 {"t": t, "k": k, "blocked": blocked})
    return out


# The four instantiations, each with its launch count and capture list
# (kernels.Entry): incc_blocks, incc_blocks_f32, incc_blocks_unblocked,
# incc_blocks_unblocked_f32.
incc_blocks.entries = block_entries("incc_blocks", "cmvs_incc_blocks")

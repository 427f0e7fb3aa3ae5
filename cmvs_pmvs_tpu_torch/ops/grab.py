"""grabTex off the fan path, under ops/texture's sampling switches: the
one place that picks how the central objective (ops/refine.
per_view_inccs) and the views' windows (models/views.grab_masked)
sample.

  * texture.SAMPLING = "bicubic": `grab_tex` + `normalize_tex` in plain
    torch on the tensors' device. No kernel samples bicubically, in the
    port as in the reference package (its `_grab_all`, refine.py:163);
  * "bilinear": the windows kernel (K2, ops/windows) or the block-INCC
    kernel (K4, ops/incc) on `grab_block_geometry`, under the block rule
    of texture._USE_BLOCK_SAMPLING unless the caller fixes it (the fan
    path's windows are always blocked, as the reference's
    `windows_pallas`).

The bicubic grabs and K2's windows run in texture.GRAB_CHUNK-row
batches, which bound their [B, T, S2, 3] buffers.
"""
from __future__ import annotations

import torch

from . import texture
from .incc import incc_blocks
from .texture import (grab_block_geometry, grab_tex, ncc_dot, normalize_tex,
                      robustincc)
from .windows import windows


def _chunks(b: int):
    step = texture.GRAB_CHUNK
    return [slice(s, s + step) for s in range(0, b, step)]


def grab_windows(cams, pyr, level: int, wsize: int, coord, px, py, normal,
                 views, valid, blocked: bool | None = None):
    """Normalized windows of every (patch, view) pair: (texs [B, T, S2, 3],
    ok [B, T]). `blocked` fixes K2's block rule (None: texture.
    _USE_BLOCK_SAMPLING); bicubic sampling ignores it."""
    if blocked is None:
        blocked = texture._USE_BLOCK_SAMPLING
    t = views.shape[1]
    texs, oks = [], []
    for sl in _chunks(coord.shape[0]):
        args = (cams, pyr, level, wsize, coord[sl], px[sl], py[sl],
                normal[sl], views[sl], valid[sl])
        if texture.SAMPLING == "bicubic":
            tex, ok = grab_tex(*args)
            tex = normalize_tex(tex, ok)
        else:
            starts, relx, rely, ok = grab_block_geometry(*args)
            tex = windows(pyr.atlas_k, starts, relx, rely, ok.reshape(-1),
                          t=t, blocked=blocked)
        texs.append(tex)
        oks.append(ok)
    if not texs:
        return (coord.new_zeros((0, t, wsize * wsize, 3)),
                torch.zeros((0, t), dtype=torch.bool, device=coord.device))
    return torch.cat(texs), torch.cat(oks)


def grab_inccs(cams, pyr, level: int, wsize: int, coord, px, py, normal,
               views, valid):
    """Robust INCC of every (patch, view) window vs view 0's: (incc [B, T],
    ok [B, T]), incc not masked by ok. Bilinear: K4 in one call, under
    texture._USE_BLOCK_SAMPLING; bicubic: `grab_windows` + `ncc_dot`, a
    GRAB_CHUNK batch at a time."""
    if texture.SAMPLING != "bicubic":
        starts, relx, rely, ok = grab_block_geometry(
            cams, pyr, level, wsize, coord, px, py, normal, views, valid)
        return incc_blocks(pyr.atlas_k, starts, relx, rely, ok.reshape(-1),
                           ok.shape[1],
                           blocked=texture._USE_BLOCK_SAMPLING), ok
    inccs, oks = [], []
    for sl in _chunks(max(coord.shape[0], 1)):
        texs, ok = grab_windows(cams, pyr, level, wsize, coord[sl], px[sl],
                                py[sl], normal[sl], views[sl], valid[sl])
        inccs.append(robustincc(1.0 - ncc_dot(texs[:, 0:1], texs)))
        oks.append(ok)
    return torch.cat(inccs), torch.cat(oks)

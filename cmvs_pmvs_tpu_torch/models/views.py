"""View-set selection for patches: the preProcess/postProcess machinery.

Counterpart of cmvs_pmvs_tpu/models/views.py (reference optim.cpp): a
patch's view set is a dense bool mask [B, N] plus a reference index [B];
slot order is recreated where it matters (slot 0 = reference). The
windows kernel (ops/windows, K2) plugs in through `grab_masked`, which
follows the reference's `_grab_masked_one` (views.py:131-149): on the
kernel path (ops/refine._use_fan) K2 blocked, as the reference's
`windows_pallas`; off it, grabTex by ops/texture's switches (ops/grab).
"""
from __future__ import annotations

import math

import torch

from ..geom.cameras import CameraSet, get_unit, project, unit3
from ..image.pyramid import PyramidSet
from ..image.sample import edge_at
from ..ops import texture
from ..ops.grab import grab_windows
from ..ops.refine import _patch_axes, _use_fan
from ..ops.texture import ncc_dot, robustincc

HUGE = 1.0e10
COS60 = math.cos(math.radians(60.0))


def _rays(cams: CameraSet, coord):
    """[B, N, 3] unit rays from each patch to every optical center."""
    return unit3(cams.center[None, :, :] - coord[:, None, :])[..., :3]


def collect_images_all(cams: CameraSet, visdata, distances, tau: int,
                       sequence: int):
    """Per reference image its tau best related views (optim.cpp:66-93).
    Returns (views [N, tau] i32 -1-padded, valid [N, tau])."""
    n = cams.num
    axes = cams.oaxis[:, :3]
    ok = visdata & (axes @ axes.T >= COS60)
    if sequence != -1:
        idx = torch.arange(n, device=axes.device)
        ok = ok & ((idx[:, None] - idx[None, :]).abs() <= sequence)
    d = torch.where(ok, distances, torch.full_like(distances, math.inf))
    order = torch.argsort(d, dim=1, stable=True)[:, :tau]
    valid = torch.gather(d, 1, order) < math.inf
    views = torch.where(valid, order, torch.full_like(order, -1))
    return views.to(torch.int32), valid


def _edge_pass(cams, pyr, level, coord):
    """[B, N] edge-map pass at the projection of coord in every view."""
    n = cams.num
    ic = project(cams.P[None, :], coord[:, None, :], level)
    ns = torch.arange(n, device=coord.device)[None]
    return edge_at(pyr, ns, level, ic[..., 0], ic[..., 1]) > 0.0, ic


def add_images(cams: CameraSet, pyr: PyramidSet, visdata, level: int,
               coord, normal, vmask, ref):
    """Add visdata neighbours of the reference that see the patch
    (optim.cpp:398-444)."""
    cand = visdata[ref.long()] & ~vmask
    edge, ic = _edge_pass(cams, pyr, level, coord)
    w = pyr.widths[level].to(ic.dtype)[None]
    h = pyr.heights[level].to(ic.dtype)[None]
    inside = ((ic[..., 0] >= 0.0) & (ic[..., 0] < w - 1)
              & (ic[..., 1] >= 0.0) & (ic[..., 1] < h - 1))
    facing = (_rays(cams, coord) * normal[:, None, :3]).sum(-1) >= COS60
    return vmask | (cand & inside & edge & facing)


def remove_images_edge(pyr: PyramidSet, cams: CameraSet, level: int,
                       coord, vmask):
    """Keep views whose edge map passes at the projection
    (optim.cpp:385-396)."""
    return vmask & _edge_pass(cams, pyr, level, coord)[0]


def grab_masked(cams, pyr, level, wsize, coord, normal, ref, vmask):
    """Normalized windows of every view in vmask, patch axes from the
    reference view: (texs [B, N, S2, 3], ok [B, N]), by ops/grab's
    switches, with K2 blocked on the kernel path (ops/refine._use_fan)."""
    px, py = _patch_axes(cams, level, ref.long(), coord, normal)
    views = torch.arange(cams.num, dtype=torch.int32,
                         device=coord.device)[None].expand(vmask.shape)
    return grab_windows(cams, pyr, level, wsize, coord, px, py, normal,
                        views, vmask,
                        blocked=True if _use_fan(None, coord) else None)


def constraint_images(cams, pyr, level, wsize, coord, normal, ref, vmask,
                      ncc_threshold):
    """Keep views with non-robust INCC vs the reference < 1 - thr
    (optim.cpp:192-206); the reference view always stays."""
    texs, ok = grab_masked(cams, pyr, level, wsize, coord, normal, ref,
                           vmask)
    rows = torch.arange(coord.shape[0], device=coord.device)
    refl = ref.long()
    incc = 1.0 - ncc_dot(texs[rows, refl][:, None], texs)
    incc = torch.where(ok & ok[rows, refl][:, None], incc,
                       torch.full_like(incc, 2.0))
    keep = vmask & (incc < 1.0 - ncc_threshold)
    keep[rows, refl] = vmask[rows, refl]
    return keep


def filter_images_by_angle(cams, coord, normal, ref, vmask,
                           angle_threshold):
    """Drop views beyond the incidence threshold; a failing reference
    clears the set (optim.cpp:124-148)."""
    good = (_rays(cams, coord) * normal[:, None, :3]).sum(-1) \
        >= torch.cos(angle_threshold)
    rows = torch.arange(coord.shape[0], device=coord.device)
    ref_good = good[rows, ref.long()]
    return torch.where(ref_good[:, None], vmask & good,
                       torch.zeros_like(vmask))


def sort_images(cams: CameraSet, level: int, coord, normal, ref, vmask,
                t: int):
    """Greedy min-unit view ordering with 10-degree cone penalties
    (optim.cpp:284-321). Returns (views [B, T] i32 -1-padded, valid
    [B, T]); slot 0 is the reference."""
    b, n = vmask.shape
    dev = coord.device
    ray3 = _rays(cams, coord)
    dots = (ray3 * normal[:, None, :3]).sum(-1)
    unit = get_unit(cams, torch.arange(n, device=dev)[None],
                    coord[:, None, :], level)
    pos = dots > 0.0
    units = torch.where(pos & vmask,
                        unit / torch.where(pos, dots, torch.ones_like(dots)),
                        torch.full_like(unit, HUGE))
    rows = torch.arange(b, device=dev)
    # scatter_ with a Python scalar: no host-to-device copy (a capturing
    # CUDA stream refuses one; models/graphs)
    units.scatter_(1, ref.long()[:, None], 0.0)
    usable = (units < HUGE).sum(1)
    threshold = 1.0 - math.cos(math.radians(10.0))
    picks, oks = [], []
    for _ in range(t):
        pick = torch.argmin(units, dim=1)
        pick_ok = units[rows, pick] < HUGE
        cone = 1.0 - (ray3 * ray3[rows, pick][:, None, :]).sum(-1)
        ftmp = cone.clamp(min=threshold / 2.0).clamp(max=threshold)
        units = units * (threshold / ftmp)
        units.scatter_(1, pick[:, None], HUGE)
        picks.append(torch.where(pick_ok, pick, torch.full_like(pick, -1)))
        oks.append(pick_ok)
    valid = torch.stack(oks, 1) & (usable >= 2)[:, None]
    views = torch.stack(picks, 1)
    return torch.where(valid, views, torch.full_like(views, -1)).to(
        torch.int32), valid


def check_angles(cams: CameraSet, coord, views, valid, min_angle,
                 max_angle):
    """Some view pair must subtend an angle in (min, max)
    (photoSetS.cpp:164-189). Returns ok [B]."""
    vid = views.clamp(min=0).long()
    r3 = unit3(cams.center[vid] - coord[:, None, :])[..., :3]
    ang = torch.acos((r3 @ r3.transpose(1, 2)).clamp(-1.0, 1.0))
    pair = valid[:, :, None] & valid[:, None, :]
    t = views.shape[1]
    iu = torch.triu_indices(t, t, offset=1, device=coord.device)
    hits = ((ang > min_angle) & (ang < max_angle) & pair)[:, iu[0], iu[1]]
    return hits.any(dim=1)


def pairwise_dots(texs):
    """[B, N, N] mean products of the [B, N, S2, 3] windows (one batched
    matmul)."""
    flat = texs.reshape(texs.shape[0], texs.shape[1], -1)
    return (flat @ flat.transpose(1, 2)) / flat.shape[-1]


def set_ref_image(cams, pyr, level, wsize, tn: int, coord, normal, ref,
                  vmask):
    """New reference = target view minimizing the summed pairwise robust
    INCC (optim.cpp:208-254). Returns (ref, ok); ok False when no target
    view remains."""
    n = vmask.shape[1]
    refs, oks = [ref[:0]], [vmask[:0, 0]]
    chunk = texture.GRAB_CHUNK
    for s in range(0, coord.shape[0], chunk):
        sl = slice(s, s + chunk)
        texs, gok = grab_masked(cams, pyr, level, wsize, coord[sl],
                                normal[sl], ref[sl], vmask[sl])
        incc = robustincc(1.0 - pairwise_dots(texs))
        incc = torch.where(gok[:, :, None] & gok[:, None, :], incc,
                           torch.full_like(incc, 2.0))
        incc = incc * (1.0 - torch.eye(n, device=incc.device))[None]
        vm = vmask[sl]
        sums = torch.where(vm[:, None, :], incc,
                           torch.zeros_like(incc)).sum(2)
        cand = vm & (torch.arange(n, device=vm.device) < tn)[None]
        sums = torch.where(cand, sums, torch.full_like(sums, math.inf))
        ok = cand.any(1)
        refs.append(torch.where(ok, torch.argmin(sums, 1).to(ref.dtype),
                                ref[sl]))
        oks.append(ok)
    return torch.cat(refs), torch.cat(oks)

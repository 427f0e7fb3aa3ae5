"""Batched patch refinement: Levenberg-Marquardt over (depth, alpha, beta).

Counterpart of cmvs_pmvs_tpu/ops/refine.py, the replacement of the
reference's per-patch BOBYQA loop (optim.cpp:496-658): the same 3-DOF
parametrization (depth along the reference ray in dscale units, two
normal angles in pi/48 units bounded by +-23.99999) and the same robust
INCC objective `my_f` (optim.cpp:507-578), minimized for B patches at
once.

Two LM paths, as in the reference package:
  * the fan path (`_refine_patches_fan`): forward-difference probes and
    Broyden updates, every objective evaluation one fan-kernel call -
    the reference package's accelerator path, and the path CUDA tensors
    take by default. `USE_FAN_V2` picks the kernel, as the reference's
    switch of the same name does: True runs v2 (`ops/fan2.incc_fan`,
    K1), False v1 (`ops/fan.incc_fan_v1`, K3, all probes of a pair
    sampled from its probe-0 tile);
  * the central-difference path (refine.py:492-571 in the reference):
    every objective evaluation is block grabs + normalize + robust INCC
    vs view 0 (`ops/incc.incc_blocks`: K4 on CUDA tensors, its plain
    twin on CPU tensors) - the reference package's CPU path, and the
    path CPU tensors take by default.
`USE_FAN` overrides the default for every call (None: fan on CUDA,
central differences on CPU; False is the reference's
USE_PALLAS_INCC=False); the per-call `use_fan=` argument overrides both.

`view_group` (the reference's `view_axis`): a process group over which a
patch's views are split, each rank holding the reference view in slot 0
and its share of the others (parallel/sharding). The objective's sums,
the normal equations and the final score's sums are all-reduced over it
at the reference's psum points, so every rank takes the same steps; as
in the reference, only the central-difference LM runs view-parallel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from ..geom.cameras import CameraSet, get_unit, project, unit3
from ..image.pyramid import PyramidSet
from .fan import grab_frames, incc_fan_v1
from .fan2 import incc_fan
from .incc import incc_blocks
from .texture import grab_block_geometry, unrobustincc

ASCALE = math.pi / 48.0         # optim.cpp:590
ANGLE_BOUND = 23.99999          # optim.cpp:601-602
HUGE = 1.0e10
FAN_H = 0.4                     # forward-difference probe step
# Jacobian refresh period of the fan LM: every REFRESH-th iteration
# evaluates the full 4-probe fan; the ones between evaluate only the
# candidate and update J by a Broyden secant (reference refine.py:309-322)
BROYDEN_REFRESH = 2
# Fan kernel: True = v2 (K1, ops/fan2), False = v1 (K3, ops/fan); the
# reference's refine.USE_FAN_V2.
USE_FAN_V2: bool = True
# LM path for calls without `use_fan=`: None = the fan LM on CUDA tensors
# and central differences on CPU tensors; True/False force one path on
# every device (False is the reference's USE_PALLAS_INCC=False).
USE_FAN: bool | None = None


@dataclass(frozen=True)
class RefineProblem:
    """Per-patch constants of one refinement batch; views[:, 0] is the
    reference view (optim.cpp:584-590)."""

    centers: torch.Tensor     # [B, 4] patch center at entry
    rays: torch.Tensor        # [B, 4] unit ray ref-center -> patch
    dscales: torch.Tensor     # [B]
    views: torch.Tensor       # [B, T] int32, -1 padded
    view_valid: torch.Tensor  # [B, T] bool
    weights: torch.Tensor     # [B, T] INCC weights (optim.cpp:592-596)
    min_image_num: int


def _clip_angles(p):
    return torch.cat([p[:, :1], p[:, 1:].clamp(-ANGLE_BOUND, ANGLE_BOUND)],
                     dim=1)


def encode_params(cams: CameraSet, prob: RefineProblem, coord, normal):
    """(coord, normal) -> [B, 3] scaled params (optim.cpp:660-688)."""
    ref = prob.views[:, 0].clamp(min=0).long()
    p0 = ((coord - prob.centers) * prob.rays).sum(-1) / prob.dscales
    n3 = normal[:, :3]
    fx = (cams.xaxis[ref] * n3).sum(-1)
    fy = (cams.yaxis[ref] * n3).sum(-1)
    fz = (cams.zaxis[ref] * n3).sum(-1)
    p2 = torch.asin(fy.clamp(-1.0, 1.0))
    cosb = torch.cos(p2)
    zero = cosb == 0.0
    safe = torch.where(zero, torch.ones_like(cosb), cosb)
    sina = fx / safe
    cosa = -fz / safe
    p1 = torch.acos(cosa.clamp(-1.0, 1.0))
    p1 = torch.where(sina < 0.0, -p1, p1)
    p1 = torch.where(zero, torch.zeros_like(p1), p1)
    return torch.stack([p0, p1 / ASCALE, p2 / ASCALE], dim=-1)


def decode_params(cams: CameraSet, prob: RefineProblem, p):
    """[B, 3] params -> (coord [B, 4], normal [B, 4]) (optim.cpp:690-707)."""
    ref = prob.views[:, 0].clamp(min=0).long()
    coord = prob.centers + (prob.dscales * p[:, 0])[:, None] * prob.rays
    a1 = p[:, 1] * ASCALE
    a2 = p[:, 2] * ASCALE
    fx = torch.sin(a1) * torch.cos(a2)
    fy = torch.sin(a2)
    fz = -torch.cos(a1) * torch.cos(a2)
    n3 = (cams.xaxis[ref] * fx[:, None] + cams.yaxis[ref] * fy[:, None]
          + cams.zaxis[ref] * fz[:, None])
    return coord, torch.cat([n3, torch.zeros_like(n3[:, :1])], dim=-1)


def compute_units(cams: CameraSet, level: int, coord, normal, views,
                  view_valid):
    """Per-view fineness: getUnit / max(ray.normal, 0) (optim.cpp:446-471);
    invalid or back-facing -> HUGE."""
    vid = views.clamp(min=0).long()
    unit = get_unit(cams, vid, coord[:, None, :], level)
    ray = unit3(cams.center[vid] - coord[:, None, :])
    denom = (ray[..., :3] * normal[:, None, :3]).sum(-1)
    pos = denom > 0.0
    fine = torch.where(pos, unit / torch.where(pos, denom,
                                               torch.ones_like(denom)),
                       torch.full_like(unit, HUGE))
    return torch.where(view_valid, fine, torch.full_like(fine, HUGE))


def set_scales(cams: CameraSet, level: int, wsize: int, coord, views,
               view_valid):
    """Per-patch (dscale, ascale) (patchOrganizerS.cpp:663-684)."""
    ref = views[:, 0].clamp(min=0).long()
    unit = get_unit(cams, ref, coord, level)
    unit2 = 2.0 * unit
    ray = unit3(coord - cams.center[ref])
    vid = views.clamp(min=0).long()
    P = cams.P[vid]
    pa = project(P, coord[:, None, :], level)
    pb = project(P, (coord - ray * unit2[:, None])[:, None, :], level)
    diff = torch.linalg.vector_norm((pa - pb)[..., :2], dim=-1)
    m = view_valid.clone()
    m[:, 0] = False
    denom = m.sum(-1).clamp(min=1)
    dmove = torch.where(m, diff, torch.zeros_like(diff)).sum(-1) / denom
    dscale = unit2 / torch.where(dmove == 0.0, torch.ones_like(dmove),
                                 dmove)
    ascale = torch.atan(dscale / (unit * wsize / 2.0))
    return dscale, ascale


def make_problem(cams: CameraSet, level: int, coord, normal, views,
                 view_valid, dscales, min_image_num: int) -> RefineProblem:
    """Batch constants (optim.cpp:582-596)."""
    ref = views[:, 0].clamp(min=0).long()
    ray = unit3(coord - cams.center[ref])
    units = compute_units(cams, level, coord, normal, views, view_valid)
    w = torch.clamp(units[:, 0:1] / units.clamp(min=1e-30), max=1.0)
    w[:, 0] = 1.0
    w = torch.where(view_valid, w, torch.zeros_like(w))
    return RefineProblem(centers=coord, rays=ray, dscales=dscales,
                         views=views, view_valid=view_valid, weights=w,
                         min_image_num=min_image_num)


def _patch_axes(cams: CameraSet, level: int, ref, coord, normal):
    """getPAxes against the reference view (optim.cpp:1127-1144)."""
    pscale = get_unit(cams, ref, coord, level)
    n3 = normal[..., :3]
    y3 = torch.linalg.cross(n3, cams.xaxis[ref])
    y3 = y3 / torch.linalg.vector_norm(y3, dim=-1, keepdim=True)
    x3 = torch.linalg.cross(y3, n3)
    zeros = torch.zeros_like(x3[..., :1])
    px = torch.cat([x3, zeros], -1) * pscale[..., None]
    py = torch.cat([y3, zeros], -1) * pscale[..., None]
    P = cams.P[ref]
    pc = project(P, coord, level)
    xdis = torch.linalg.vector_norm(
        (project(P, coord + px, level) - pc)[..., :2], dim=-1)
    ydis = torch.linalg.vector_norm(
        (project(P, coord + py, level) - pc)[..., :2], dim=-1)
    px = px / torch.where(xdis == 0.0, torch.ones_like(xdis), xdis)[..., None]
    py = py / torch.where(ydis == 0.0, torch.ones_like(ydis), ydis)[..., None]
    return px, py


def _use_fan(use_fan, coord) -> bool:
    if use_fan is not None:
        return use_fan
    return coord.is_cuda if USE_FAN is None else USE_FAN


def _incc_probes(cams, pyr, level, wsize, views, view_valid, cf, nf):
    """Raw robust INCCs + validity for [fan, B, 4] probe stacks through
    the fan kernel USE_FAN_V2 selects: (incc [B, T, fan],
    ok [B, T, fan])."""
    vid, tile_org, frames, ok = grab_frames(cams, pyr, level, wsize, views,
                                            view_valid, cf, nf)
    if USE_FAN_V2:
        return incc_fan(pyr.atlas_u8, vid, frames, ok, wsize), ok
    return incc_fan_v1(pyr.atlas_u8, vid, tile_org, frames, ok, wsize), ok


def per_view_inccs(cams, pyr, level, wsize, prob: RefineProblem, coord,
                   normal, use_fan: bool | None = None):
    """Robust INCC of each non-reference view vs the reference window
    (my_f's reference branch, optim.cpp:556-575). Returns (incc [B, T]
    with 2.0 at invalid pairs, ref_ok [B], pair_ok [B, T])."""
    if _use_fan(use_fan, coord):
        incc, ok = _incc_probes(cams, pyr, level, wsize, prob.views,
                                prob.view_valid, coord[None], normal[None])
        incc, ok = incc[..., 0], ok[..., 0]
    else:
        ref = prob.views[:, 0].clamp(min=0).long()
        px, py = _patch_axes(cams, level, ref, coord, normal)
        starts, relx, rely, ok = grab_block_geometry(
            cams, pyr, level, wsize, coord, px, py, normal, prob.views,
            prob.view_valid)
        incc = incc_blocks(pyr.atlas_u8, starts, relx, rely, ok.reshape(-1),
                           ok.shape[1])
    ref_ok = ok[:, 0]
    pair_ok = ok & ref_ok[:, None]
    pair_ok[:, 0] = False
    return torch.where(pair_ok, incc, torch.full_like(incc, 2.0)), ref_ok, \
        pair_ok


def _all_reduce(t, group):
    """Sum of `t` over the ranks of `group` (the reference's psum)."""
    from ..parallel.comm import all_reduce_
    return all_reduce_(t, group=group)


def incc_objective(cams, pyr, level, wsize, prob: RefineProblem, p,
                   use_fan: bool | None = None, view_group=None):
    """The scalar objective my_f (optim.cpp:507-578), batched. With
    `view_group`, the per-view sums and counts are summed over the
    group's view shards (the reference counts the reference view once).
    Returns (f [B], incc [B, T], pair_ok [B, T])."""
    coord, normal = decode_params(cams, prob, p)
    incc, ref_ok, pair_ok = per_view_inccs(cams, pyr, level, wsize, prob,
                                           coord, normal, use_fan)
    denom = pair_ok.sum(-1)
    nviews = prob.view_valid.sum(-1)
    total = torch.where(pair_ok, incc, torch.zeros_like(incc)).sum(-1)
    if view_group is not None:
        # one all-reduce for reference refine.py:267-270's three psums;
        # the counts are small integers, exact in float32
        sums = _all_reduce(torch.stack([denom.to(total.dtype),
                                        (nviews - 1).to(total.dtype),
                                        total]), view_group)
        denom = sums[0].to(denom.dtype)
        nviews = sums[1].to(nviews.dtype) + 1
        total = sums[2]
    mininum = nviews.clamp(max=prob.min_image_num)
    mean = total / denom.clamp(min=1)
    bad = (~ref_ok) | (denom < mininum - 1)
    return torch.where(bad, torch.full_like(mean, 2.0), mean), incc, pair_ok


def _solve3x3(A, b):
    """Batched closed-form 3x3 solve via the adjugate (callers damp A)."""
    a, b_, c = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    d, e, f = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    g, h, i = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    co00, co01, co02 = e * i - f * h, c * h - b_ * i, b_ * f - c * e
    co10, co11, co12 = f * g - d * i, a * i - c * g, c * d - a * f
    co20, co21, co22 = d * h - e * g, b_ * g - a * h, a * e - b_ * d
    det = a * co00 + b_ * co10 + c * co20
    inv = torch.where(det.abs() < 1e-30, torch.zeros_like(det), 1.0 / det)
    x0 = (co00 * b[:, 0] + co01 * b[:, 1] + co02 * b[:, 2]) * inv
    x1 = (co10 * b[:, 0] + co11 * b[:, 1] + co12 * b[:, 2]) * inv
    x2 = (co20 * b[:, 0] + co21 * b[:, 1] + co22 * b[:, 2]) * inv
    return torch.stack([x0, x1, x2], dim=-1)


def _lm_delta(J, r, lam, p):
    """Damped normal-equation step, clipped like the reference."""
    JtJ = J.transpose(1, 2) @ J
    Jtr = (J * r[..., None]).sum(1)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)[None]
    damped = JtJ + lam[:, None, None] * eye + 1e-9 * eye
    delta = _solve3x3(damped, -Jtr).clamp(-4.0, 4.0)
    p_cand = _clip_angles(p + delta)
    return p_cand, p_cand - p


def _residuals(incc, pair_ok):
    r = torch.sqrt(torch.where(pair_ok, incc.clamp(min=0.0),
                               torch.zeros_like(incc)) + 1e-8)
    return torch.where(pair_ok, r, torch.zeros_like(r))


def _refine_patches_fan(cams, pyr, level, wsize, prob: RefineProblem,
                        coord, normal, num_iters, active,
                        with_ncc: bool = True):
    """LM with fused fan evaluations (reference refine.py:325-461): full
    refreshes evaluate the candidate plus 3 forward-difference probes in
    one incc_fan call; the iterations between evaluate the candidate
    only and update J by a Broyden secant on accepted steps."""
    p0 = _clip_angles(encode_params(cams, prob, coord, normal))
    h = FAN_H
    mininum = prob.view_valid.sum(-1).clamp(max=prob.min_image_num)

    def masked_objective(incc, ok):
        """(f [B, F], r [B, T, F]) from raw fan INCCs and validity."""
        ref_ok = ok[:, 0, :]
        pair_ok = ok & ref_ok[:, None, :]
        pair_ok[:, 0, :] = False
        incc = torch.where(pair_ok, incc, torch.full_like(incc, 2.0))
        denom = pair_ok.sum(1)
        mean = torch.where(pair_ok, incc, torch.zeros_like(incc)).sum(1) \
            / denom.clamp(min=1)
        f_fan = torch.where((~ref_ok) | (denom < mininum[:, None] - 1),
                            torch.full_like(mean, 2.0), mean)
        return f_fan, _residuals(incc, pair_ok)

    def evaluate(ps):
        """f, r for a [fan, B, 3] parameter stack."""
        cf, nf = zip(*(decode_params(cams, prob, q) for q in ps))
        incc, ok = _incc_probes(cams, pyr, level, wsize, prob.views,
                                prob.view_valid, torch.stack(cf),
                                torch.stack(nf))
        return masked_objective(incc, ok)

    def fan_eval(p):
        ps = [p]
        for k in range(3):
            q = p.clone()
            q[:, k] += h
            ps.append(q)
        f_fan, r_fan = evaluate(ps)
        J = (r_fan[..., 1:] - r_fan[..., 0:1]) / h
        return f_fan[:, 0], r_fan[..., 0], J

    f, r, J = fan_eval(p0)
    p = p0
    lam = torch.zeros_like(f) + 1e-3
    refresh = BROYDEN_REFRESH
    for it in range(num_iters):
        p_cand, delta = _lm_delta(J, r, lam, p)
        if it % refresh == refresh - 1:
            f_new, r_new, J_new = fan_eval(p_cand)
        else:
            f_fan, r_fan = evaluate([p_cand])
            f_new, r_new = f_fan[:, 0], r_fan[..., 0]
            # Broyden secant: J' = J + ((dr - J delta) delta^T) / |delta|^2
            Jd = (J * delta[:, None, :]).sum(-1)
            dd = (delta * delta).sum(-1).clamp(min=1e-12)
            J_new = J + ((r_new - r - Jd) / dd[:, None])[..., None] \
                * delta[:, None, :]
        accept = (f_new < f) & active
        p = torch.where(accept[:, None], p_cand, p)
        r = torch.where(accept[:, None], r_new, r)
        J = torch.where(accept[:, None, None], J_new, J)
        f = torch.where(accept, f_new, f)
        lam = torch.where(accept, lam * 0.3, lam * 4.0).clamp(1e-5, 1e4)

    new_coord, new_normal = decode_params(cams, prob, p)
    new_coord = torch.where(active[:, None], new_coord, coord)
    new_normal = torch.where(active[:, None], new_normal, normal)
    ncc = None
    if with_ncc:
        # the weighted score from the final accepted residuals
        # r = sqrt(incc + 1e-8) (reference refine.py:443-458)
        pair_ok = r > 0.0
        incc_v = torch.where(pair_ok, (r * r - 1e-8).clamp(min=0.0),
                             torch.zeros_like(r))
        w = torch.where(pair_ok, prob.weights, torch.zeros_like(r))
        total = w.sum(-1)
        zero = total == 0.0
        score = (incc_v * w).sum(-1) / torch.where(
            zero, torch.ones_like(total), total)
        score = torch.where(zero, torch.full_like(score, 2.0), score)
        ncc = 1.0 - unrobustincc(score)
    return new_coord, new_normal, ncc, f


def refine_patches(cams: CameraSet, pyr: PyramidSet, level: int, wsize: int,
                   prob: RefineProblem, coord, normal, num_iters: int = 12,
                   active=None, with_ncc: bool = True,
                   use_fan: bool | None = None, view_group=None):
    """Damped Gauss-Newton minimization of the robust INCC objective
    (replaces refinePatchBFGS, optim.cpp:580-658). Returns (coord,
    normal, ncc, final_f); `active` [B] bool rows pass through unchanged
    when False. The fan path runs when `use_fan` is True, or when it is
    None and USE_FAN is True, or when both are None and the tensors are
    on CUDA; never with `view_group` (the views split over its ranks,
    reference refine.py:485), which takes the central-difference LM on
    every device (its objective is K4 on CUDA)."""
    if active is None:
        active = torch.ones(coord.shape[0], dtype=torch.bool,
                            device=coord.device)
    if view_group is None and _use_fan(use_fan, coord):
        return _refine_patches_fan(cams, pyr, level, wsize, prob, coord,
                                   normal, num_iters, active,
                                   with_ncc=with_ncc)

    p = _clip_angles(encode_params(cams, prob, coord, normal))
    b = coord.shape[0]
    prob6 = replace(prob, **{
        name: torch.cat([getattr(prob, name)] * 6, dim=0)
        for name in ("centers", "rays", "dscales", "views", "view_valid",
                     "weights")})

    def residuals(pp, pr):
        f, incc, pair_ok = incc_objective(cams, pyr, level, wsize, pr, pp,
                                          use_fan=False,
                                          view_group=view_group)
        return f, _residuals(incc, pair_ok)

    f, r = residuals(p, prob)
    lam = torch.zeros_like(f) + 1e-3
    h = 0.4
    eye = torch.eye(3, dtype=p.dtype, device=p.device)[None]
    for _ in range(num_iters):
        # all 6 central-difference probes as ONE 6x-batched objective
        probes = []
        for k in range(3):
            dp = torch.zeros_like(p)
            dp[:, k] = h
            probes.extend([p + dp, p - dp])
        r6 = residuals(torch.cat(probes, dim=0), prob6)[1]
        rs = [r6[i * b:(i + 1) * b] for i in range(6)]
        J = torch.stack([(rs[2 * k] - rs[2 * k + 1]) / (2.0 * h)
                         for k in range(3)], dim=-1)            # [B, T, 3]
        JtJ = J.transpose(1, 2) @ J
        Jtr = (J * r[..., None]).sum(1)
        if view_group is not None:
            # reference refine.py:539-541: psum of the normal equations
            both = _all_reduce(torch.cat([JtJ, Jtr[..., None]], -1),
                               view_group)
            JtJ, Jtr = both[..., :3], both[..., 3]
        damped = JtJ + (lam + 1e-9)[:, None, None] * eye
        delta = _solve3x3(damped, -Jtr).clamp(-4.0, 4.0)
        p_new = _clip_angles(p + delta)
        f_new, r_new = residuals(p_new, prob)
        accept = (f_new < f) & active
        p = torch.where(accept[:, None], p_new, p)
        r = torch.where(accept[:, None], r_new, r)
        lam = torch.where(accept, lam * 0.3, lam * 4.0).clamp(1e-5, 1e4)
        f = torch.where(accept, f_new, f)

    new_coord, new_normal = decode_params(cams, prob, p)
    new_coord = torch.where(active[:, None], new_coord, coord)
    new_normal = torch.where(active[:, None], new_normal, normal)
    ncc = compute_weighted_incc(cams, pyr, level, wsize, prob, new_coord,
                                new_normal, use_fan=False,
                                view_group=view_group) \
        if with_ncc else None
    return new_coord, new_normal, ncc, f


def compute_weighted_incc(cams, pyr, level, wsize, prob: RefineProblem,
                          coord, normal, use_fan: bool | None = None,
                          view_group=None):
    """patch._ncc = 1 - unrobustincc(weighted robust INCC)
    (optim.cpp:652 + computeINCC :875-938); with `view_group` the
    weighted sums are summed over the group's view shards."""
    incc, ref_ok, pair_ok = per_view_inccs(cams, pyr, level, wsize, prob,
                                           coord, normal, use_fan)
    w = torch.where(pair_ok, prob.weights, torch.zeros_like(incc))
    total = w.sum(-1)
    num = (incc * w).sum(-1)
    if view_group is not None:
        # reference refine.py:583-585
        total, num = _all_reduce(torch.stack([total, num]), view_group)
    zero = total == 0.0
    score = num / torch.where(zero, torch.ones_like(total), total)
    score = torch.where(zero | (~ref_ok), torch.full_like(score, 2.0), score)
    return 1.0 - unrobustincc(score)

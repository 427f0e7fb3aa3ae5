"""Roofline bounds of the port's kernels K1 (`ops/fan2.incc_fan`) and K2
(`ops/windows.windows`), counted from the inputs of each launch.

Copied unchanged from the repository's `chip_smoke.py` (`bound`,
`call_bound`, `FLOPS_PER_SAMPLE`, `atlas_bytes`, `fan_taps`,
`fan_atlas_bytes`, `block_atlas_bytes`, `block_need`, `block_bytes`),
with the two things they imported from the port copied beside them:
the fan kernels' sample lattice (`ops/fan.window_positions`) and the
block size (`ops/texture.BLOCK_K`). A kernel's least time is the larger
of its compulsory bytes over the H100's HBM bandwidth and its float32
operations over the card's non-tensor peak (NVIDIA's data sheet, SXM,
700 W): each input and output once, the distinct atlas pixels read.

`Counter` is what the traced run hangs on a kernel wrapper's launch
capture hook (`kernels.Entry.capture`, which keeps the wrapper's
arguments of every eager launch): it counts each launch's bound on the
spot and keeps no tensor.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# float32 operations per (pair[, probe], sample) of each kernel:
#   K1: 8 lattice position, 4 bilinear fractions, 33 bilinear RGB, 3 sum,
#       3 deviation, 6 square-sum, 6 cross-sum
#   K3: K1 + 2 tile-relative shifts
#   K2: 4 weights, 27 bilinear RGB, 3 sum, 3 deviation, 6 square-sum,
#       3 normalize
#   K4: K2 + 6 cross-sum
FLOPS_PER_SAMPLE = {"incc_fan": 63, "incc_fan_v1": 65, "windows": 46,
                    "incc_blocks": 52}
BLOCK_K = 20       # the block kernels' block (ops/texture.BLOCK_K)
TILE_PX = 32       # the v1 fan kernel's tile (ops/fan.TILE_PX)


def base_name(name: str) -> str:
    """The kernel of an instantiation name: windows_unblocked_f32 ->
    windows, incc_fan_v1_f32 -> incc_fan_v1."""
    return name.removesuffix("_f32").removesuffix("_unblocked")


def atlas_bytes(atlas, n, y, x) -> int:
    """Bytes of the distinct atlas pixels that the taps (n, y, x) read:
    3 a pixel on a uint8 atlas, 12 on a float32 (gamma) one."""
    _, h, wa, c = atlas.shape
    flat = (n.long() * h + y.long().clamp(0, h - 1)) * wa \
        + x.long().clamp(0, wa - 1)
    return int(torch.unique(flat.flatten()).numel()) * c \
        * atlas.element_size()


def bound(name: str, samples: int, nbytes: int) -> dict:
    """The least time the H100 could take: compulsory bytes over HBM
    bandwidth vs float32 operations over the non-tensor peak."""
    flops = samples * FLOPS_PER_SAMPLE[base_name(name)]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def window_positions(frames, wsize: int):
    """Sample positions (x, y), each [..., S2], of the wsize x wsize
    lattice org + gx * d_x + gy * d_y of frames [..., 6]."""
    margin = wsize // 2
    s = torch.arange(wsize * wsize, device=frames.device)
    gx = (s % wsize - margin).to(torch.float32)
    gy = (s // wsize - margin).to(torch.float32)
    fr = frames[..., None, :]
    return (fr[..., 0] + gx * fr[..., 2] + gy * fr[..., 4],
            fr[..., 1] + gx * fr[..., 3] + gy * fr[..., 5])


def fan_taps(frames, ok, tile_org=None, wsize: int = 7):
    """Rows, columns and keep-masks of the four bilinear taps of every
    sample of every ok probe; with tile_org, only the taps inside the
    pair's tile are kept."""
    x, y = window_positions(frames, wsize)                  # [B,T,F,S2]
    keep = ok[..., None].expand_as(x)
    fx, fy = torch.floor(x).long(), torch.floor(y).long()
    cols = [fx, fx + 1, fx, fx + 1]
    rows = [fy, fy, fy + 1, fy + 1]
    masks = [keep] * 4
    if tile_org is not None:
        ox = tile_org[:, :, None, None, 0].long()
        oy = tile_org[:, :, None, None, 1].long()
        masks = [keep & (c >= ox) & (c < ox + TILE_PX) & (r >= oy)
                 & (r < oy + TILE_PX) for c, r in zip(cols, rows)]
    return rows, cols, masks


def fan_atlas_bytes(atlas, vid, frames, ok, tile_org=None,
                    wsize: int = 7) -> int:
    rows, cols, masks = fan_taps(frames, ok, tile_org, wsize)
    n = vid[:, :, None, None].expand_as(rows[0])
    return atlas_bytes(atlas, torch.cat([n[m] for m in masks]),
                       torch.cat([r[m] for r, m in zip(rows, masks)]),
                       torch.cat([c[m] for c, m in zip(cols, masks)]))


def block_atlas_bytes(atlas, starts, relx, rely, ok,
                      blocked: bool = True) -> int:
    """Bytes of the distinct atlas pixels that the taps read, over the
    pairs with `ok`: blocked, the taps inside their block, block starts
    clamped into the atlas as the kernels clamp them; unblocked, every
    tap (clamped into the atlas plane by atlas_bytes)."""
    num, h, wa, _ = atlas.shape
    fx, fy = torch.floor(relx).long(), torch.floor(rely).long()
    keep = ok[:, None].expand_as(fx)
    n = starts[:, 0:1].long().clamp(0, num - 1).expand_as(fx)[keep]
    sy, sx = starts[:, 1:2].long(), starts[:, 2:3].long()
    if blocked:
        sy = sy.clamp(0, max(h - BLOCK_K, 0))
        sx = sx.clamp(0, max(wa - BLOCK_K, 0))
    sy, sx = sy.expand_as(fx)[keep], sx.expand_as(fx)[keep]
    fx, fy = fx[keep], fy[keep]
    taps = [(dx, dy) for dx in (0, 1) for dy in (0, 1)]
    inside = [(fx + dx >= 0) & (fx + dx < BLOCK_K) & (fy + dy >= 0)
              & (fy + dy < BLOCK_K) if blocked
              else torch.ones_like(fx, dtype=torch.bool) for dx, dy in taps]
    return atlas_bytes(
        atlas, torch.cat([n[m] for m in inside]),
        torch.cat([(sy + fy + dy)[m] for (_, dy), m in zip(taps, inside)]),
        torch.cat([(sx + fx + dx)[m] for (dx, _), m in zip(taps, inside)]))


def block_need(name: str, ok, t: int):
    """The pairs whose window K2 ("windows") or K4 ("incc_blocks") must
    read: K2's ok pairs; K4's ok pairs of patches whose view 0 is ok."""
    if base_name(name) == "windows":
        return ok
    okb = ok.reshape(-1, t)
    return (okb & okb[:, 0:1]).reshape(-1)


def block_bytes(name: str, atlas, starts, relx, rely, ok, t: int,
                old: bool = False, blocked: bool = True) -> int:
    """Compulsory bytes of one K2 or K4 call: every pair's `starts`, `ok`
    and output (a failed pair still writes its zeros or its 2.0), and for
    the pairs of `block_need` their relx/rely and the distinct atlas
    pixels their taps read. old: the earlier count, every pair's
    relx/rely and the taps of every ok pair."""
    bt, s2 = relx.shape
    need = ok if old else block_need(name, ok, t)
    rel = relx.numel() * 2 if old else 2 * s2 * int(need.sum())
    out = bt * s2 * 3 if base_name(name) == "windows" else bt
    return nbytes(starts, ok) + 4 * (rel + out) \
        + block_atlas_bytes(atlas, starts, relx, rely, need, blocked)


def call_bound(name: str, args: tuple, kwargs: dict) -> dict:
    """`bound` of one call, counted from its own inputs (the wrapper's
    arguments as its launch capture keeps them)."""
    atlas = args[0]
    if base_name(name) in ("incc_fan", "incc_fan_v1"):
        vid, *org, frames, ok, wsize = args[1:]
        pairs = frames.shape[:3].numel()
        return bound(name, pairs * wsize * wsize,
                     nbytes(vid, *org, frames, ok) + 4 * pairs
                     + fan_atlas_bytes(atlas, vid, frames, ok,
                                       org[0] if org else None, wsize))
    relx, ok, t = args[2], args[4], kwargs["t"]
    blocked = kwargs.get("blocked", True)
    need = int(block_need(name, ok, t).sum())
    return bound(name, need * relx.shape[1],
                 block_bytes(name, *args, t=t, blocked=blocked))


class Counter:
    """A launch capture hook (`kernels.Entry.capture`) that adds up the
    bounds of the launches of one kernel instantiation as they come: the
    calls, bytes, operations and least milliseconds, and how many calls
    bytes bounded."""

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.bytes = 0
        self.flops = 0
        self.bound_ms = 0.0
        self.by_bytes = 0

    def append(self, launch):
        args, kwargs = launch
        b = call_bound(self.name, args, kwargs)
        self.calls += 1
        self.bytes += b["bytes"]
        self.flops += b["flops"]
        self.bound_ms += b["bound_ms"]
        self.by_bytes += b["bound_by"] == "bytes"

    def bound_by(self) -> str:
        """What bounds most of the calls."""
        return "bytes" if 2 * self.by_bytes >= self.calls else "operations"

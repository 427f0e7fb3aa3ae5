"""Harris + Difference-of-Gaussians feature detection on image batches.

Counterpart of cmvs_pmvs_tpu/ops/detect.py (reference harris.cpp,
dog.cpp, detectFeatures.cpp): all N views as one [N, H, W, 3] batch,
separable zero-padded correlations written as shifted-slice sums, and
the per-32px-bucket top-4 selection as a stable sort (ties go to the
lower index, like lax.top_k).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def gauss_kernel(sigma: float) -> np.ndarray:
    """Normalized Gaussian taps, margin ceil(2 sigma) (detector.cpp:29-47)."""
    margin = int(math.ceil(2 * sigma))
    xs = np.arange(-margin, margin + 1, dtype=np.float64)
    g = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def _corr1d(img, taps, dim: int):
    """Zero-padded 1D correlation of [N, H, W, C] along dim 1 or 2."""
    m = len(taps) // 2
    size = img.shape[dim]
    pad = [0, 0] * (img.dim() - dim - 1) + [m, m]
    xp = torch.nn.functional.pad(img, pad)
    out = torch.zeros_like(img)
    for j, kv in enumerate(taps):
        out = out + float(kv) * xp.narrow(dim, j, size)
    return out


def _sep_conv(img, kx, ky):
    out = img
    if kx is not None:
        out = _corr1d(out, kx, 2)
    if ky is not None:
        out = _corr1d(out, ky, 1)
    return out


DERIV3 = np.array([-0.5, 0.0, 0.5], np.float32)
BOX3 = np.array([1.0 / 3.0] * 3, np.float32)


def harris_response(img, mask, sigma: float = 4.0):
    """Harris response with strict 4-neighbour NMS (harris.cpp:114-171).
    img [N, H, W, 3] in [0, 255]; mask [N, H, W]. Returns [N, H, W]."""
    I = img / 255.0 * mask[..., None]
    dIdx = _sep_conv(I, DERIV3, BOX3)
    dIdy = _sep_conv(I, BOX3, DERIV3)
    dxx = (dIdx * dIdx).sum(-1, keepdim=True)
    dyy = (dIdy * dIdy).sum(-1, keepdim=True)
    dxy = (dIdx * dIdy).sum(-1, keepdim=True)
    g = gauss_kernel(sigma)
    prods = torch.cat([dxx, dyy, dxy], -1) * mask[..., None]
    prods = _sep_conv(prods, g, g)
    dxx, dyy, dxy = prods[..., 0], prods[..., 1], prods[..., 2]
    resp = (dxx * dyy - dxy * dxy - 0.06 * (dxx + dyy) ** 2) * mask
    r = torch.nn.functional.pad(resp, (1, 1, 1, 1), value=-math.inf)
    keep = ((resp >= r[:, 1:-1, 2:]) & (resp >= r[:, 1:-1, :-2])
            & (resp >= r[:, 2:, 1:-1]) & (resp >= r[:, :-2, 1:-1]))
    interior = torch.zeros_like(keep)
    interior[:, 1:-1, 1:-1] = True
    keep = keep | ~interior
    return torch.where(keep, resp, torch.zeros_like(resp))


def dog_responses(img, mask, first_scale: float = 1.0,
                  last_scale: float = 3.0):
    """|DoG| at accepted local extrema per centre scale (dog.cpp:128-184).
    Returns ([S, N, H, W], centre scales)."""
    step = math.sqrt(2.0)
    steps = max(4, int(math.ceil(math.log(last_scale / first_scale)
                                 / math.log(step))))
    I = img / 255.0 * mask[..., None]
    res = []
    for i in range(steps + 2):
        g = gauss_kernel(first_scale * step ** i)
        res.append(torch.linalg.vector_norm(_sep_conv(I, g, g), dim=-1))
    dogs = [res[i + 1] - res[i] for i in range(len(res) - 1)]
    out, cscales = [], []
    for i in range(2, steps):
        pdog, v, ndog = dogs[i - 2], dogs[i - 1], dogs[i]
        cscales.append(first_scale * step ** (i + 1))
        p = torch.nn.functional.pad(v, (1, 1, 1, 1))
        n8 = torch.stack([p[:, :-2, :-2], p[:, :-2, 1:-1], p[:, :-2, 2:],
                          p[:, 1:-1, :-2], p[:, 1:-1, 2:], p[:, 2:, :-2],
                          p[:, 2:, 1:-1], p[:, 2:, 2:]], 0)
        is_max = (v > 0) & (n8 < v[None]).all(0) & (pdog < v) & (ndog < v)
        is_min = (v <= 0) & (n8 > v[None]).all(0) & (pdog > v) & (ndog > v)
        interior = torch.zeros_like(is_max)
        interior[:, 1:-1, 1:-1] = True
        hit = (is_max | is_min) & interior & (v != 0.0) & (mask > 0)
        out.append(torch.where(hit, v.abs(), torch.zeros_like(v)))
    return torch.stack(out), cscales


def bucket_topk(resp, valid, gridsize: int, k: int = 4):
    """Top-k responses per gridsize^2 bucket (harris.cpp:192-237).
    Returns (x, y, r, ok), each [N, num_buckets * k]."""
    n, h, w = resp.shape
    gh, gw = -(-h // gridsize), -(-w // gridsize)
    pad = (0, gw * gridsize - w, 0, gh * gridsize - h)
    r = torch.nn.functional.pad(resp, pad)
    v = torch.nn.functional.pad(valid.to(torch.uint8), pad).bool()
    score = torch.where(v, r, torch.full_like(r, -math.inf))
    score = score.reshape(n, gh, gridsize, gw, gridsize).permute(
        0, 1, 3, 2, 4).reshape(n, gh * gw, gridsize * gridsize)
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    b = torch.arange(gh * gw, device=resp.device)
    y = (b // gw)[None, :, None] * gridsize + idx // gridsize
    x = (b % gw)[None, :, None] * gridsize + idx % gridsize
    return (x.reshape(n, -1), y.reshape(n, -1), top.reshape(n, -1),
            torch.isfinite(top).reshape(n, -1))


def detect_features(img, mask, widths, heights, fcsize: int = 16):
    """Harris + DoG features of a level image batch (findMatch.cpp:80-82).
    img [N, H, W, 3]; mask [N, H, W] (mask & edge); widths/heights [N].
    Returns a dict of [N, F] tensors: x, y, response, type (0 harris,
    1 dog), valid."""
    n, h, w = img.shape[:3]
    gridsize = fcsize * 2
    dev = img.device
    xs = torch.arange(w, device=dev)[None, None, :]
    ys = torch.arange(h, device=dev)[None, :, None]
    wd = widths.to(dev)[:, None, None]
    ht = heights.to(dev)[:, None, None]
    inside = ((xs < wd) & (ys < ht)).to(img.dtype)

    def margin_ok(m):
        return (xs >= m) & (xs < wd - m) & (ys >= m) & (ys < ht - m)

    hr = harris_response(img, mask * inside)
    hx, hy, hrv, hok = bucket_topk(hr, (hr != 0.0) & margin_ok(8), gridsize)

    dr, cscales = dog_responses(img, mask * inside)
    fired = torch.zeros_like(dr[0], dtype=torch.bool)
    dmap = torch.zeros_like(dr[0])
    for s in range(dr.shape[0]):
        cur = (dr[s] != 0.0) & ~fired & margin_ok(int(math.ceil(2 * cscales[s])))
        fired = fired | (dr[s] != 0.0)
        dmap = dmap + torch.where(cur, dr[s], torch.zeros_like(dr[s]))
    dx, dy, drv, dok = bucket_topk(dmap, dmap != 0.0, gridsize)
    return {"x": torch.cat([hx, dx], 1), "y": torch.cat([hy, dy], 1),
            "response": torch.cat([hrv, drv], 1),
            "type": torch.cat([torch.zeros_like(hx), torch.ones_like(dx)], 1),
            "valid": torch.cat([hok, dok], 1)}

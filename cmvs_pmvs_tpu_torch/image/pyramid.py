"""Image/mask/edge pyramids of all views packed into one mip atlas.

Counterpart of cmvs_pmvs_tpu/image/pyramid.py: level l of every view
occupies columns [xoff[l], xoff[l] + w0 >> l) of one [N, H0, WA, 3]
atlas so a per-(patch, view) level is an ordinary index. Semantics
follow the reference (image.cpp:135-405): w_l = w_{l-1} // 2, a 4x4
binomial {1,3,3,1}^2/64 stride-2 downsample that skips the last
row/column and renormalizes at borders, per-level rounding to the byte
grid, and 2x2 any-in mask/edge downsampling.

The atlas stays float32 (uint8-valued) for the plain tensor code, and
`atlas_u8` holds one uint8 copy for the CUDA kernels (ops/fan2,
ops/windows) to read - the GPU replacement of the TPU tile copies.
Gamma-decoded (non-byte) atlases are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch


@dataclass(frozen=True)
class PyramidSet:
    """All pyramids of all views in packed mip-atlas form."""

    atlas: torch.Tensor       # [N, H0, WA, 3] f32, uint8-valued colors
    atlas_u8: torch.Tensor    # [N, H0, WA, 3] u8 copy for the kernels
    mask_atlas: torch.Tensor  # [N, H0, WA] f32: 1.0 = in mask
    edge_atlas: torch.Tensor  # [N, H0, WA] f32: 1.0 = textured/usable
    widths: torch.Tensor      # [L, N] i32 true per-view width per level
    heights: torch.Tensor     # [L, N] i32
    xoff: torch.Tensor        # [L] i32 x offset of each level
    num_levels: int

    @property
    def num_images(self) -> int:
        return self.atlas.shape[0]


_K1 = (1.0, 3.0, 3.0, 1.0)


def _binomial_downsample(img, valid):
    """One pyramid step. img [N, H, W, C], valid [N, H, W] (1 where a tap
    may be used). Every partial sum is a multiple of 1/64 below 2^18, so
    the result is exact in f32 whatever the summation order - the
    downsample is bit-identical to the reference's convolution."""
    n, h, w, c = img.shape
    oh, ow = h // 2, w // 2
    ph, pw = 2 * oh + 3, 2 * ow + 3
    hh, ww = min(h, ph - 1), min(w, pw - 1)

    def pad(x):
        out = x.new_zeros((n, ph, pw) + x.shape[3:])
        out[:, 1:1 + hh, 1:1 + ww] = x[:, :hh, :ww]
        return out

    xp = pad(img * valid[..., None])
    vp = pad(valid)
    num = img.new_zeros((n, oh, ow, c))
    den = img.new_zeros((n, oh, ow))
    for i in range(4):
        for j in range(4):
            wgt = _K1[i] * _K1[j] / 64.0
            num = num + wgt * xp[:, i:i + 2 * oh:2, j:j + 2 * ow:2]
            den = den + wgt * vp[:, i:i + 2 * oh:2, j:j + 2 * ow:2]
    pos = den > 0.0
    safe = torch.where(pos, den, torch.ones_like(den))
    out = torch.where(pos[..., None], num / safe[..., None],
                      torch.zeros_like(num))
    return torch.floor(out + 0.5)


def _any_in_downsample(mask):
    n, h, w = mask.shape
    oh, ow = h // 2, w // 2
    return mask[:, :oh * 2, :ow * 2].reshape(n, oh, 2, ow, 2).amax(
        dim=(2, 4))


def _dims_mask(widths, heights, h, w, inclusive_last: bool):
    """[N, h, w] 1.0 inside each view's true dims (tap validity excludes
    the last row/column, image.cpp:262-267)."""
    xs = np.arange(w)[None, None, :]
    ys = np.arange(h)[None, :, None]
    sub = 1 if inclusive_last else 2
    if inclusive_last:
        m = (xs < widths[:, None, None]) & (ys < heights[:, None, None])
    else:
        m = ((xs <= widths[:, None, None] - sub)
             & (ys <= heights[:, None, None] - sub))
    return m.astype(np.float32)


def build_pyramids(images: list[np.ndarray],
                   masks: list[np.ndarray] | None, num_levels: int,
                   edges: list[np.ndarray] | None = None,
                   device="cpu") -> PyramidSet:
    """Packed PyramidSet from per-view uint8 RGB images; views without a
    mask or edge map are all-in (image.hpp:180-203)."""
    dev = torch.device(device)
    n = len(images)
    widths = [np.array([im.shape[1] for im in images], np.int64)]
    heights = [np.array([im.shape[0] for im in images], np.int64)]
    for _ in range(1, num_levels):
        widths.append(widths[-1] // 2)
        heights.append(heights[-1] // 2)
    h0, w0 = int(heights[0].max()), int(widths[0].max())
    img0 = np.zeros((n, h0, w0, 3), np.float32)
    msk0 = np.zeros((n, h0, w0), np.float32)
    edg0 = np.zeros((n, h0, w0), np.float32)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        img0[i, :h, :w] = im.astype(np.float32)
        msk0[i, :h, :w] = 1.0 if masks is None or masks[i] is None \
            else (masks[i] > 0).astype(np.float32)
        edg0[i, :h, :w] = 1.0 if edges is None or edges[i] is None \
            else (edges[i] > 0).astype(np.float32)

    imgs = [torch.as_tensor(img0, device=dev)]
    msks = [torch.as_tensor(msk0, device=dev)]
    edgs = [torch.as_tensor(edg0, device=dev)]
    ph, pw = h0, w0
    for lv in range(1, num_levels):
        valid = torch.as_tensor(_dims_mask(widths[lv - 1], heights[lv - 1],
                                           ph, pw, False), device=dev)
        img = _binomial_downsample(imgs[-1], valid)
        ph, pw = ph // 2, pw // 2
        inside = torch.as_tensor(_dims_mask(widths[lv], heights[lv], ph, pw,
                                            True), device=dev)
        imgs.append(img * inside[..., None])
        msks.append(_any_in_downsample(msks[-1]) * inside)
        edgs.append(_any_in_downsample(edgs[-1]) * inside)

    xoff = np.zeros(num_levels, np.int64)
    for lv in range(1, num_levels):
        xoff[lv] = xoff[lv - 1] + max(1, w0 >> (lv - 1))
    wa = int(xoff[-1] + max(1, w0 >> (num_levels - 1)))
    atlas = torch.zeros((n, h0, wa, 3), device=dev)
    mask_atlas = torch.zeros((n, h0, wa), device=dev)
    edge_atlas = torch.zeros((n, h0, wa), device=dev)
    for lv in range(num_levels):
        hl, wl = imgs[lv].shape[1:3]
        xs = int(xoff[lv])
        atlas[:, :hl, xs:xs + wl] = imgs[lv]
        mask_atlas[:, :hl, xs:xs + wl] = msks[lv]
        edge_atlas[:, :hl, xs:xs + wl] = edgs[lv]

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

    return PyramidSet(atlas=atlas, atlas_u8=atlas.to(torch.uint8),
                      mask_atlas=mask_atlas, edge_atlas=edge_atlas,
                      widths=i32(np.stack(widths)),
                      heights=i32(np.stack(heights)), xoff=i32(xoff),
                      num_levels=num_levels)


def set_edge(pyr: PyramidSet, images: list[np.ndarray],
             threshold: float) -> PyramidSet:
    """Texturedness masks: Gaussian-blurred squared central gradients
    thresholded at thr^2 (2m+1)^2 / 3 (image.cpp:407-471)."""
    sigma = 3.0
    margin = int(np.floor(2 * sigma))
    xs = np.arange(-margin, margin + 1)
    g = np.exp(-xs * xs / (2.0 * sigma * sigma)).astype(np.float32)
    new_thr = threshold * threshold * (2 * margin + 1) ** 2 / 3.0
    edge_maps = []
    for im in images:
        imf = im.astype(np.float32)
        gx = np.zeros_like(imf)
        gy = np.zeros_like(imf)
        gx[1:-1, 1:-1] = imf[1:-1, 2:] - imf[1:-1, :-2]
        gy[1:-1, 1:-1] = imf[2:, 1:-1] - imf[:-2, 1:-1]
        grad = np.zeros(imf.shape[:2], np.float32)
        grad[1:-1, 1:-1] = (gx * gx + gy * gy)[1:-1, 1:-1].sum(axis=-1)
        blurred = _sep_filter_clamp(grad, g)
        edge_maps.append((blurred > new_thr).astype(np.uint8) * 255)
    rebuilt = build_pyramids(images, None, pyr.num_levels, edges=edge_maps,
                             device=pyr.atlas.device)
    return replace(pyr, edge_atlas=rebuilt.edge_atlas)


def _sep_filter_clamp(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Separable correlation with clamp-to-edge borders (filterG)."""
    m = len(kernel) // 2
    padded = np.pad(img, ((0, 0), (m, m)), mode="edge")
    out = np.zeros_like(img)
    for i, kv in enumerate(kernel):
        out += kv * padded[:, i:i + img.shape[1]]
    padded = np.pad(out, ((m, m), (0, 0)), mode="edge")
    out2 = np.zeros_like(img)
    for i, kv in enumerate(kernel):
        out2 += kv * padded[i:i + img.shape[0], :]
    return out2

"""Engine configuration: static problem shape and dynamic thresholds.

Counterpart of cmvs_pmvs_tpu/models/config.py (reference
findMatch.hpp:111-145, findMatch.cpp:23-107).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class EngineConfig:
    """Problem shape and per-run constants."""

    level: int
    csize: int
    wsize: int
    tn: int             # number of target images
    n: int              # total images
    tau: int            # max views in optimization (findMatch.cpp:56)
    min_image_num: int
    t_store: int        # stored view slots per patch
    p_cap: int          # patch capacity
    gh: int             # padded grid height
    gw: int             # padded grid width
    sequence: int = -1
    seed_cand: int = 6  # refined candidates per seed cell
    cell_k: int = 16    # per-cell fan-out cap in filters
    bindexes: tuple = ()

    @staticmethod
    def from_options(opt, n_images: int, tn: int, gh: int, gw: int,
                     p_cap: int, bindexes: tuple = ()) -> "EngineConfig":
        tau = min(opt.min_image_num * 2, n_images)
        return EngineConfig(
            level=opt.level, csize=opt.csize, wsize=opt.wsize, tn=tn,
            n=n_images, tau=tau, min_image_num=opt.min_image_num,
            t_store=max(2 * tau, 12) if n_images > 2 * tau else n_images,
            p_cap=p_cap, gh=gh, gw=gw, sequence=opt.sequence,
            bindexes=tuple(bindexes))


@dataclass(frozen=True)
class Thresholds:
    """Dynamic thresholds as 0-d device tensors (findMatch.cpp:92-106),
    float32 like the reference so relaxation rounds identically."""

    ncc: torch.Tensor
    ncc_before: torch.Tensor
    angle0: torch.Tensor
    angle1: torch.Tensor
    max_angle: torch.Tensor
    quad: torch.Tensor
    ep: torch.Tensor
    count1: torch.Tensor      # int32
    neighbor: torch.Tensor
    neighbor1: torch.Tensor
    neighbor2: torch.Tensor

    @staticmethod
    def initial(ncc_threshold: float, max_angle: float, quad: float,
                device="cpu") -> "Thresholds":
        def f(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        deg = math.pi / 180.0
        return Thresholds(
            ncc=f(ncc_threshold), ncc_before=f(ncc_threshold - 0.3),
            angle0=f(60.0 * deg), angle1=f(60.0 * deg),
            max_angle=f(max_angle), quad=f(quad), ep=f(2.0),
            count1=torch.tensor(4, dtype=torch.int32, device=device),
            neighbor=f(0.5), neighbor1=f(1.0), neighbor2=f(1.0))

    def relaxed(self) -> "Thresholds":
        """updateThreshold: -0.05 ncc per iteration, count1 -> 2."""
        return replace(self, ncc=self.ncc - 0.05,
                       ncc_before=self.ncc_before - 0.05,
                       count1=torch.full_like(self.count1, 2))

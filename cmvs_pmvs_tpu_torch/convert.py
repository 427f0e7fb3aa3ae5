"""Carry reference-package state into the port.

There are no weights; the state of a reconstruction is cameras, pyramid,
patch cloud, grid and thresholds, and CMVS's clustering problem. Each `*_from_numpy` takes a mapping of
the JAX dataclass's field names to numpy arrays (e.g.
`{f.name: np.asarray(getattr(x, f.name)) for f in fields(x)}`) plus a
device, and casts to the port's dtypes, so tests can feed both packages
identical state. `engine_state_from_jax_checkpoint` reads the npz that
the reference's `PMVSEngine.save_checkpoint` writes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .geom.cameras import CameraSet
from .image.pyramid import PyramidSet, kernel_atlas
from .models.cmvs import CmvsProblem
from .models.config import Thresholds
from .models.grid import GridState
from .models.patches import PatchCloud

_INT_FIELDS = {"images", "grids", "vimages", "vgrids", "timages", "dflag",
               "counts", "occ", "vocc", "depth_idx", "count1", "widths",
               "heights", "xoff"}


def _tensor(name: str, a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif name in _INT_FIELDS:
        dtype = torch.int32
    else:
        dtype = torch.float32
    return torch.as_tensor(a.astype(np.dtype(str(dtype).split(".")[1])),
                           device=device)


def _build(cls, fields: dict, device, prefix: str = ""):
    return cls(**{f.name: _tensor(f.name, fields[prefix + f.name], device)
                  for f in dataclasses.fields(cls)})


def camera_set_from_numpy(fields: dict, device="cpu") -> CameraSet:
    return _build(CameraSet, fields, device)


def pyramid_from_numpy(fields: dict, device="cpu") -> PyramidSet:
    """The reference PyramidSet's fields; its TPU tile copies are dropped
    and the kernels' copy of the atlas is rebuilt (uint8, or the float32
    atlas itself where `byte_valued` is False: a gamma pyramid)."""
    byte_valued = bool(fields.get("byte_valued", True))
    atlas = _tensor("atlas", fields["atlas"], device)
    return PyramidSet(
        atlas=atlas, atlas_k=kernel_atlas(atlas, byte_valued),
        mask_atlas=_tensor("mask_atlas", fields["mask_atlas"], device),
        edge_atlas=_tensor("edge_atlas", fields["edge_atlas"], device),
        widths=_tensor("widths", fields["widths"], device),
        heights=_tensor("heights", fields["heights"], device),
        xoff=_tensor("xoff", fields["xoff"], device),
        num_levels=int(fields["num_levels"]), byte_valued=byte_valued)


def cloud_from_numpy(fields: dict, device="cpu") -> PatchCloud:
    return _build(PatchCloud, fields, device)


def grid_from_numpy(fields: dict, device="cpu") -> GridState:
    return _build(GridState, fields, device)


def thresholds_from_numpy(fields: dict, device="cpu") -> Thresholds:
    return _build(Thresholds, fields, device)


def engine_state_from_jax_checkpoint(npz_path: str, device="cpu"):
    """(cloud, grid, thresholds, iteration) from a reference checkpoint
    (cloud_*/grid_*/thr_* arrays plus `iteration`)."""
    with np.load(npz_path) as data:
        d = {k: data[k] for k in data.files}
    return (_build(PatchCloud, d, device, "cloud_"),
            _build(GridState, d, device, "grid_"),
            _build(Thresholds, d, device, "thr_"), int(d["iteration"]))


def cmvs_problem_from_arrays(coords, visibles, centers, ipscales, widths,
                             heights, dlevel, device="cpu"):
    """The port's CmvsProblem from a CMVS problem's fields (e.g. those of
    the JAX package's CmvsProblem, read off it by name): coordinates,
    centres and scales as float64 tensors on `device`, image sizes as
    int64 arrays, visibles as lists of ints."""
    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)
    return CmvsProblem(
        coords=f64(coords), visibles=[[int(i) for i in v] for v in visibles],
        centers=f64(centers), ipscales=f64(ipscales),
        widths=np.asarray(widths, np.int64),
        heights=np.asarray(heights, np.int64), dlevel=int(dlevel))

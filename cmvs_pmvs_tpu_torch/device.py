"""Device selection and moving state between devices.

The engine and CLI default to `cuda` and raise when no CUDA device is
present: the CPU runs only when a caller passes `device="cpu"`
explicitly (tests, debugging), never as a silent fallback.
"""
from __future__ import annotations

import dataclasses

import torch


def resolve_device(device: str | torch.device | None = "cuda"
                   ) -> torch.device:
    """torch.device for `device` (default cuda); raises if it is a CUDA
    device and CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def tree_to(obj, device: torch.device):
    """Copy of a (possibly nested) dataclass with every tensor field moved
    to `device`; non-tensor fields are kept."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj

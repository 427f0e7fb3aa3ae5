"""The ablation wrappers' contract on the CPU (no kernel is launched here).

The mode tuples of ops/ablate follow the mode enums of csrc/ablate.cu
(a wrapper passes a mode's index to the kernel), the view and window
limits of K5 and K7 match the kernel source, the shape checks accept and
reject at those limits, a CPU call runs the plain version without
counting a launch, the ctypes bindings of the K5/K7 entry points (the
library's and the occupancy sweep's) match the source, and the occupancy
sweep needs CUDA.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cmvs_pmvs_tpu_torch.ops import ablate as A  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import kernels as K  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.fan import tile_counts  # noqa: E402
from cmvs_pmvs_tpu_torch.scripts import ablate_occupancy as OCC  # noqa: E402

SRC = (Path(A.__file__).resolve().parents[1] / "csrc" / "ablate.cu") \
    .read_text()


def _enum_modes(kernel: str):
    """Mode names of the enum `kK5Full, kK5NoMoments, ...` of `kernel`."""
    body = re.search(r"enum \{ (k" + kernel + r"Full[^}]*) \};", SRC)
    names = [n.strip()[len(kernel) + 1:] for n in body.group(1).split(",")]
    return tuple(re.sub(r"(?<!^)([A-Z])", r"_\1", n).lower() for n in names)


@pytest.mark.parametrize("kernel,modes", [
    ("K5", A.FAN_ABL_MODES), ("K6", A.INTERP_ABL_MODES),
    ("K7", A.MOMENTS_ABL_MODES)])
def test_mode_tuples_follow_kernel_enums(kernel, modes):
    assert _enum_modes(kernel) == modes


@pytest.mark.parametrize("name,value", [
    ("kK5MaxWsize", A.FAN_ABL_MAX_WSIZE),
    ("kK7MaxS2", A.MOMENTS_ABL_MAX_S2)])
def test_limits_match_kernel_source(name, value):
    assert int(re.search(name + r" = (\d+);", SRC).group(1)) == value


@pytest.mark.parametrize("t,wsize", [(0, 7), (33, 7), (6, 0),
                                     (6, A.FAN_ABL_MAX_WSIZE + 1)])
def test_fan_abl_shape_check_rejects(t, wsize):
    with pytest.raises(ValueError):
        A.check_fan_abl_shape("incc_fan_abl", t, wsize)


@pytest.mark.parametrize("t,wsize", [(1, 1), (6, 7), (6, 12), (6, 13),
                                     (32, A.FAN_ABL_MAX_WSIZE)])
def test_fan_abl_shape_check_accepts(t, wsize):
    A.check_fan_abl_shape("incc_fan_abl", t, wsize)


@pytest.mark.parametrize("t,wsize", [(0, 7), (33, 7), (6, 0), (6, 9)])
def test_moments_abl_shape_check_rejects(t, wsize):
    with pytest.raises(ValueError):
        A.check_moments_abl_shape("moments_abl", t, wsize)


@pytest.mark.parametrize("t,wsize", [(1, 1), (6, 5), (6, 7), (32, 8)])
def test_moments_abl_shape_check_accepts(t, wsize):
    A.check_moments_abl_shape("moments_abl", t, wsize)


@pytest.mark.parametrize("source,name,signature", [
    ("ablate.cu", "cmvs_fan_abl", K._SIGNATURES["cmvs_fan_abl"]),
    ("ablate.cu", "cmvs_moments_abl", K._SIGNATURES["cmvs_moments_abl"]),
    (OCC.SOURCE, "cmvs_occ_fan_abl", OCC.SIGNATURES["cmvs_occ_fan_abl"]),
    (OCC.SOURCE, "cmvs_occ_moments_abl",
     OCC.SIGNATURES["cmvs_occ_moments_abl"])])
def test_ctypes_signatures_match_the_source(source, name, signature):
    """Each C entry point's parameters, pointer or int, are the ones its
    ctypes binding passes."""
    text = (K.CSRC / source).read_text()
    params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                       text).group(1).split(",")
    assert ["*" in p for p in params] == [
        a is not ctypes.c_int for a in signature]


def test_occupancy_driver_requires_cuda(monkeypatch):
    """The occupancy sweep raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(OCC, "build", lambda: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="CUDA"):
        OCC.main([])


def _case(seed=0, b=4, t=3, fan=2, s2=9):
    """A tiny batch on a random atlas: tilemap, K5 geometry, K6 positions
    and K7 frames."""
    rng = np.random.default_rng(seed)
    atlas = torch.tensor(rng.integers(0, 256, (2, 40, 50, 3), np.uint8))
    ty, tx = tile_counts(40, 50)
    tilemap = ((rng.integers(0, 2, (b, t)) << 20)
               | (rng.integers(0, ty, (b, t)) << 10)
               | rng.integers(0, tx, (b, t))).astype(np.int32)
    geom = np.zeros((4, b * t * fan, 4), np.float32)
    geom[0:2, :, 0] = rng.uniform(2.0, 29.0, (2, b * t * fan))
    geom[0, :, 1] = geom[1, :, 2] = 1.0
    rel = rng.uniform(-2.0, 34.0, (2, b, t, fan, s2))
    frames = np.concatenate([rng.uniform(4.0, 26.0, (b, t, fan, 2)),
                             rng.uniform(0.75, 1.25, (b, t, fan, 4))], -1)
    return (atlas, torch.tensor(tilemap), torch.tensor(geom.reshape(4, -1)),
            torch.tensor(rel, dtype=torch.float32),
            torch.tensor(frames, dtype=torch.float32))


def test_cpu_calls_run_plain_uncounted():
    atlas, tilemap, geom, rel, frames = _case()
    wrappers = (A.incc_fan_abl, A.interp_abl, A.moments_abl)
    before = [w.launches for w in wrappers]
    for mode in A.FAN_ABL_MODES:
        assert torch.equal(
            A.incc_fan_abl(atlas, tilemap, geom, fan=2, mode=mode, wsize=3),
            A.incc_fan_abl_plain(atlas, tilemap, geom, fan=2, mode=mode,
                                 wsize=3))
    for mode in A.INTERP_ABL_MODES:
        assert torch.equal(A.interp_abl(atlas, tilemap, rel, mode=mode),
                           A.interp_abl_plain(atlas, tilemap, rel, mode=mode))
    for mode in A.MOMENTS_ABL_MODES:
        assert torch.equal(
            A.moments_abl(atlas, tilemap, frames, mode=mode, wsize=3),
            A.moments_abl_plain(atlas, tilemap, frames, mode=mode, wsize=3))
    assert [w.launches for w in wrappers] == before

"""The port's engine against the JAX engine with bicubic sampling
(texture.SAMPLING = "bicubic", the reference's FURUKAWA_IMAGE_BICUBIC):
no kernel samples bicubically, so both engines take their non-kernel
route (grab_tex + normalize_tex + ncc_dot) everywhere.

test_torch_pipeline.py's 5-camera 128x96 plane scene and bars (patch
counts within 10%, both medians of plane distance / dscale < 0.3 and
within 0.05), through test_torch_variants_engine.py's runner; a file of
its own to keep each file near two minutes on one CPU.
"""
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_variants_engine import (  # noqa: E402
    alive_cloud, check_bars, read_ply_colors, run_both)

import cmvs_pmvs_tpu_torch.ops.texture as TT  # noqa: E402


@pytest.fixture(scope="module")
def bicubic(tmp_path_factory):
    return run_both(tmp_path_factory, "bicubic")


def test_bicubic_meets_pipeline_bars(bicubic):
    scene, out = bicubic
    check_bars(scene, alive_cloud(out["jax"][1]),
               alive_cloud(out["torch"][1]))
    assert TT.SAMPLING == "bilinear"      # restored after the run
    root, eng, _ = out["torch"]
    base = os.path.join(root, "models", "option.txt")
    assert len(read_ply_colors(base + ".ply")) == int(eng.cloud.count())


def test_bicubic_routes_every_grab(bicubic):
    """Every grab of the port's run sampled bicubically: the bicubic
    sampler ran, the windows/K4 plain versions never did (they sample
    bilinearly)."""
    _, out = bicubic
    route = out["torch"][2]
    assert route.bicubic > 0 and route.block == {}

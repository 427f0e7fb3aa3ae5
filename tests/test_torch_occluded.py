"""The port's engine on the occluded multi-object scene.

Counterpart of tests/test_occluded.py, on the port's CPU path: the same
scene, options and run, with the same bars. Occlusions and depth
discontinuities produce real outliers, so filterOutside, filterExact and
filterSmallGroups (reference source/pmvs/filter.cpp:29-355) do real work
here. The JAX test holds the JAX engine to the same bars.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu_torch.models.engine import reconstruct  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import (  # noqa: E402
    make_occluded_scene, write_pmvs_tree)


@pytest.fixture(scope="module")
def recon(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("occl"))
    scene = make_occluded_scene(num_cameras=8, width=160, height=120,
                                focal=220.0)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                "timages -1 0 8\noimages 0\n")
    eng = reconstruct(root, "option.txt", p_cap=12000, expand_iters=1,
                      max_waves=2, refine_iters=8, log=lambda *a: None,
                      device="cpu")
    alive = eng.cloud.alive.numpy()
    coord = eng.cloud.coord.numpy()[alive][:, :3]
    dscale = eng.cloud.dscale.numpy()[alive]
    return scene, eng, coord, dscale


def test_occluded_accuracy(recon):
    scene, _, coord, dscale = recon
    assert len(coord) > 400, len(coord)
    d = scene.surface_distance(coord) / dscale
    print(f"[occluded] patches {len(coord)} median {np.median(d):.4f} "
          f"q90 {np.quantile(d, 0.9):.4f}")
    # most patches lie on a true surface despite the occlusions
    assert np.median(d) < 0.4, np.median(d)
    assert np.quantile(d, 0.9) < 1.5, np.quantile(d, 0.9)


def test_occluded_multi_surface(recon):
    """Patches land on the boxes, not just the ground plane."""
    _, _, coord, _ = recon
    elevated = (coord[:, 2] > 0.1).sum()
    print(f"[occluded] elevated {elevated}")
    assert elevated > 50, elevated


def test_filters_prune_outliers(recon):
    """The filter stage removed something (real outliers exist here)."""
    _, eng, _, _ = recon
    removed = 0
    for st in eng.stats:
        for k in ("outside", "exact", "neighbor", "groups"):
            if k in st:
                a, b = st[k]
                removed += a - b
    print(f"[occluded] stats {eng.stats}")
    assert removed > 0, eng.stats

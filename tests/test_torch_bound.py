"""useBound / bimages.dat in the port: reconstruction restricted to a
bounding view, held to the JAX engine (tests/test_bound.py).

Reference: option.cpp:301-324 (initBindexes), findMatch.cpp:109-118
(insideBimages), gates at seed.cpp:314 / optim.cpp:153 / expand.cpp:212.
Both engines reconstruct test_bound.py's 5-camera 128x96 plane scene on
the CPU with image 2 as the bound: the same bindexes, every port patch
projecting inside image 2, and the port's count within 10% of JAX's.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu.models.engine import reconstruct as jax_reconstruct  # noqa
from cmvs_pmvs_tpu.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

from cmvs_pmvs_tpu_torch.models.engine import reconstruct  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.options import read_bimages  # noqa: E402

OPTION = ("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\nCPU 4\n"
          "setEdge 0\nuseBound 1\nuseVisData 0\nsequence -1\n"
          "timages -1 0 5\noimages 0\n")
RUN = dict(p_cap=6000, expand_iters=1, max_waves=2, refine_iters=6,
           log=lambda *a: None)


@pytest.fixture(scope="module")
def bounded(tmp_path_factory):
    scene = make_plane_scene(num_cameras=5, width=128, height=96)
    out = {}
    for name in ("jax", "torch"):
        root = str(tmp_path_factory.mktemp(f"bound_{name}"))
        write_pmvs_tree(scene, root)
        with open(os.path.join(root, "option.txt"), "w") as f:
            f.write(OPTION)
        with open(os.path.join(root, "bimages.dat"), "w") as f:
            f.write("1\n2\n")
        if name == "jax":
            out[name] = jax_reconstruct(root, "option.txt", **RUN)
        else:
            out[name] = reconstruct(root, "option.txt", device="cpu", **RUN)
    return scene, out


def test_bound_bindexes_match_jax(bounded):
    _, out = bounded
    assert out["torch"].cfg.bindexes == out["jax"].cfg.bindexes == (2,)


def test_bound_restricts_patches(bounded):
    """Every patch projects inside image 2, as in test_bound.py."""
    scene, out = bounded
    alive = out["torch"].cloud.alive.numpy()
    assert alive.sum() > 100
    coord = out["torch"].cloud.coord.numpy()[alive].astype(np.float64)
    pr = (scene.P[2] @ coord.T).T
    xy = pr[:, :2] / pr[:, 2:3]
    assert (xy[:, 0] >= -0.51).all() and (xy[:, 0] <= 127.51).all()
    assert (xy[:, 1] >= -0.51).all() and (xy[:, 1] <= 95.51).all()


def test_bound_count_matches_jax(bounded):
    _, out = bounded
    nj = int(np.asarray(out["jax"].cloud.alive).sum())
    nt = int(out["torch"].cloud.alive.sum())
    assert nj > 100 and abs(nt - nj) <= 0.1 * nj, (nt, nj)


def test_read_bimages_maps_ids(tmp_path):
    with open(os.path.join(str(tmp_path), "bimages.dat"), "w") as f:
        f.write("3\n10 20 99\n")
    # on-disk ids [10, 20, 30] -> engine indices; 99 unknown is skipped
    assert read_bimages(str(tmp_path), [10, 20, 30]) == (0, 1)

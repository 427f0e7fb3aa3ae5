"""The port's main path as a whole against the JAX engine.

Both packages reconstruct test_pipeline.py's plane scene on the CPU (the
port through its CPU path: central-difference LM, plain windows). Bars:
patch counts within 10%, both medians of plane distance / dscale < 0.3
and within 0.05 of each other, and the port's outputs read back through
cmvs_pmvs_tpu.io.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu.io.patches import read_patch_file, read_pset  # noqa
from cmvs_pmvs_tpu.io.ply import read_ply_xyz  # noqa: E402
from cmvs_pmvs_tpu.models.engine import reconstruct as jax_reconstruct  # noqa
from cmvs_pmvs_tpu.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

from cmvs_pmvs_tpu_torch.models.engine import reconstruct  # noqa: E402

OPTION = ("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\nCPU 4\n"
          "setEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
          "timages -1 0 5\noimages 0\n")
RUN = dict(p_cap=6000, expand_iters=1, max_waves=2, refine_iters=8,
           log=lambda *a: None)


@pytest.fixture(scope="module")
def recon(tmp_path_factory):
    scene = make_plane_scene(num_cameras=5, width=128, height=96)
    out = {}
    for name in ("jax", "torch"):
        root = str(tmp_path_factory.mktemp(name))
        write_pmvs_tree(scene, root)
        with open(os.path.join(root, "option.txt"), "w") as f:
            f.write(OPTION)
        if name == "jax":
            eng = jax_reconstruct(root, "option.txt", **RUN)
            alive = np.asarray(eng.cloud.alive)
            cloud = {k: np.asarray(getattr(eng.cloud, k))[alive]
                     for k in ("coord", "dscale")}
        else:
            eng = reconstruct(root, "option.txt", device="cpu", **RUN)
            alive = eng.cloud.alive.numpy()
            cloud = {k: getattr(eng.cloud, k).numpy()[alive]
                     for k in ("coord", "dscale")}
        out[name] = (root, eng, cloud)
    return scene, out


def _median_offset(scene, cloud):
    return float(np.median(scene.plane_distance(cloud["coord"][:, :3])
                           / cloud["dscale"]))


def test_patch_counts_agree(recon):
    _, out = recon
    nj = len(out["jax"][2]["coord"])
    nt = len(out["torch"][2]["coord"])
    assert nj > 300 and abs(nt - nj) <= 0.1 * nj, (nt, nj)


def test_accuracy_agrees(recon):
    scene, out = recon
    mj = _median_offset(scene, out["jax"][2])
    mt = _median_offset(scene, out["torch"][2])
    assert mj < 0.3 and mt < 0.3, (mj, mt)
    assert abs(mj - mt) < 0.05, (mj, mt)


def test_outputs_read_back(recon):
    _, out = recon
    root, eng, cloud = out["torch"]
    base = os.path.join(root, "models", "option.txt")
    n = len(cloud["coord"])
    patches = read_patch_file(base + ".patch")
    assert len(patches) == n
    assert len(read_ply_xyz(base + ".ply")) == n
    coords, _ = read_pset(base + ".pset")
    assert len(coords) == n
    assert all(len(p.images) >= 3 for p in patches)
    assert all(0 <= i < 5 for p in patches for i in p.images)
    np.testing.assert_allclose(coords, cloud["coord"][:, :3], atol=1e-5)
    assert os.path.exists(base + ".trace.json")

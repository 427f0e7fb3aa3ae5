"""Auto-grow capacity and truncation counters in the port's engine
(tests/test_capacity.py, on the port's CPU path).

A run whose patch cloud overflows a tiny initial p_cap must grow and
finish with the same cloud as a run given ample capacity from the
start; the cell_k and view truncation counters are reported in
PMVSEngine.stats. The ample run is held to the JAX engine's on the same
tree with test_torch_pipeline.py's bars: patch counts within 10%, both
medians of plane distance / dscale < 0.3 and within 0.05 of each other.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu.models import engine as JE  # noqa: E402
from cmvs_pmvs_tpu.utils.options import PMVSOptions as JaxOptions  # noqa
from cmvs_pmvs_tpu.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

from cmvs_pmvs_tpu_torch.models.engine import (  # noqa: E402
    PMVSEngine, load_scene)
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("grow"))
    scene = make_plane_scene(num_cameras=5, width=192, height=144,
                             focal=260.0)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                "timages -1 0 5\noimages 0\n")
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    return load_scene(root, opt, device="cpu"), opt, scene, root


def _run(data, opt, p_cap):
    eng = PMVSEngine(data, opt, p_cap=p_cap, log=lambda *a: None,
                     device="cpu")
    eng.run(expand_iters=1, max_waves=2, refine_iters=6)
    return eng


@pytest.fixture(scope="module")
def runs(tree):
    data, opt, _, _ = tree
    return _run(data, opt, 1024), _run(data, opt, 16384)


def test_autogrow_matches_large_capacity(runs):
    small, large = runs
    assert small.p_cap > 1024, "overflow never triggered auto-grow"
    n_small = int(small.cloud.alive.sum())
    n_large = int(large.cloud.alive.sum())
    assert n_small == n_large > 1024, (n_small, n_large)
    # the same patch set, not just the same count
    cs = small.cloud.coord.numpy()[small.cloud.alive.numpy()]
    cl = large.cloud.coord.numpy()[large.cloud.alive.numpy()]
    np.testing.assert_allclose(np.sort(cs, axis=0), np.sort(cl, axis=0),
                               atol=1e-5)


def test_truncation_counters_surface(runs):
    _, large = runs
    assert large.stats, "no iteration stats recorded"
    for st in large.stats:
        assert "cell_trunc" in st and "view_drops" in st
        assert st["cell_trunc"] >= 0 and st["view_drops"] >= 0


def test_ample_run_matches_jax(tree, runs):
    """The port's ample-capacity run against the JAX engine's on the same
    tree, options and depth."""
    _, _, scene, root = tree
    jopt = JaxOptions.parse(os.path.join(root, "option.txt"))
    jeng = JE.PMVSEngine(JE.load_scene(root, jopt), jopt, p_cap=16384,
                         log=lambda *a: None)
    jeng.run(expand_iters=1, max_waves=2, refine_iters=6)
    jalive = np.asarray(jeng.cloud.alive)
    large = runs[1]
    alive = large.cloud.alive.numpy()
    nj, nt = int(jalive.sum()), int(alive.sum())
    assert nj > 300 and abs(nt - nj) <= 0.1 * nj, (nt, nj)

    def median(coord, dscale):
        return float(np.median(scene.plane_distance(coord[:, :3])
                               / dscale))
    mj = median(np.asarray(jeng.cloud.coord)[jalive],
                np.asarray(jeng.cloud.dscale)[jalive])
    mt = median(large.cloud.coord.numpy()[alive],
                large.cloud.dscale.numpy()[alive])
    assert mj < 0.3 and mt < 0.3, (mj, mt)
    assert abs(mj - mt) < 0.05, (mj, mt)

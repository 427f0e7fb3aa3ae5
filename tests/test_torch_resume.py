"""Mid-run checkpoint and resume in the port's engine
(tests/test_fault.py::test_midrun_checkpoint_resume_equals_uninterrupted,
on the port's CPU path).

A reconstruction checkpointed after iteration 1 (the reference package's
npz layout) and resumed in a fresh engine with run(start_iter=1)
produces the same cloud as the uninterrupted 2-iteration run, and that
cloud is held to the JAX engine's uninterrupted run on the same tree
with test_torch_pipeline.py's bars: patch counts within 10%, both medians
of plane distance / dscale < 0.3 and within 0.05 of each other.
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


def test_midrun_checkpoint_resume_equals_uninterrupted(tmp_path):
    root = str(tmp_path / "scene")
    scene = make_plane_scene(num_cameras=5, width=96, height=72,
                             focal=140.0)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                "timages -1 0 5\noimages 0\n")
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt, device="cpu")
    kw = dict(max_waves=2, refine_iters=4)

    def engine():
        return PMVSEngine(data, opt, p_cap=8192, log=lambda *a: None,
                          device="cpu")

    # the uninterrupted 2-iteration run
    eng_a = engine()
    eng_a.run(expand_iters=2, **kw)

    # a "crashed" run: stop after iteration 1, checkpoint, resume in a
    # fresh engine (nothing carried over but the npz)
    eng_b = engine()
    eng_b.run(expand_iters=1, **kw)
    ckpt = os.path.join(root, "state.npz")
    eng_b.save_checkpoint(ckpt, iteration=1)
    del eng_b

    eng_c = engine()
    assert eng_c.load_checkpoint(ckpt) == 1
    eng_c.run(expand_iters=2, start_iter=1, **kw)

    a_alive = eng_a.cloud.alive.numpy()
    c_alive = eng_c.cloud.alive.numpy()
    n_a, n_c = int(a_alive.sum()), int(c_alive.sum())
    assert n_a > 0
    assert n_a == n_c, (n_a, n_c)
    c_a = np.sort(eng_a.cloud.coord.numpy()[a_alive][:, :3], axis=0)
    c_c = np.sort(eng_c.cloud.coord.numpy()[c_alive][:, :3], axis=0)
    np.testing.assert_allclose(c_a, c_c, atol=1e-5)

    # the resumed cloud against the JAX engine's uninterrupted run
    jopt = JaxOptions.parse(os.path.join(root, "option.txt"))
    jeng = JE.PMVSEngine(JE.load_scene(root, jopt), jopt, p_cap=8192,
                         log=lambda *a: None)
    jeng.run(expand_iters=2, **kw)
    j_alive = np.asarray(jeng.cloud.alive)
    n_j = int(j_alive.sum())
    assert abs(n_c - n_j) <= 0.1 * n_j, (n_c, n_j)

    def median(coord, dscale):
        return float(np.median(scene.plane_distance(coord[:, :3])
                               / dscale))
    mj = median(np.asarray(jeng.cloud.coord)[j_alive],
                np.asarray(jeng.cloud.dscale)[j_alive])
    mc = median(eng_c.cloud.coord.numpy()[c_alive],
                eng_c.cloud.dscale.numpy()[c_alive])
    assert mj < 0.3 and mc < 0.3, (mj, mc)
    assert abs(mj - mc) < 0.05, (mj, mc)

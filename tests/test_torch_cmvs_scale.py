"""The port's CMVS at maximage scale against the JAX package (slow tier,
as test_cmvs_scale.py is): the 300-camera / 30,000-point ring bundle
clusters as the JAX package clusters it, within test_cmvs_scale.py's
bars (cluster sizes <= maximage, point coverage > 0.7, counted by
chip_smoke's phase-11 helper), and
test_config5_scale's 1,000 cameras / 100,000 points finish with bounded
clusters. CPU path, one torch thread.
"""
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

pytestmark = pytest.mark.slow

from cmvs_pmvs_tpu.models import cmvs as J  # noqa: E402

from cmvs_pmvs_tpu_torch.convert import cmvs_problem_from_arrays  # noqa
from cmvs_pmvs_tpu_torch.models import cmvs as T  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import make_ring_bundle  # noqa

QUIET = dict(log=lambda *a: None)


def cmvs_coverage(c) -> float:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.cmvs_coverage(c)


@pytest.fixture(scope="module")
def big_run():
    f = make_ring_bundle()
    a = J.CmvsClustering(J.CmvsProblem(**f), maximage=40, **QUIET)
    a.run()
    b = T.CmvsClustering(cmvs_problem_from_arrays(**f, device="cpu"),
                         maximage=40, **QUIET)
    t0 = time.time()
    b.run()
    return a, b, time.time() - t0


def test_clusters_equal_jax(big_run):
    a, b, _ = big_run
    assert b.timages == a.timages
    assert np.array_equal(b.removed, a.removed)
    assert b.neighbors == a.neighbors
    assert np.array_equal(b.coords.numpy(), a.coords)


def test_cluster_sizes_and_coverage(big_run):
    _, b, dt = big_run
    assert len(b.timages) >= 2
    for t in b.timages:
        assert 0 < len(t) <= b.maximage
    assert cmvs_coverage(b) > 0.7
    assert dt < 150.0, dt


def test_config5_scale():
    f = make_ring_bundle(n_cams=1000, n_pts=100_000, seed=7,
                         vis_window=(0.04, 0.12))
    c = T.CmvsClustering(cmvs_problem_from_arrays(**f, device="cpu"),
                         maximage=50, **QUIET)
    t0 = time.time()
    c.run()
    dt = time.time() - t0
    assert dt < 280.0, dt
    assert len(c.timages) >= 2
    for t in c.timages:
        assert 0 < len(t) <= c.maximage

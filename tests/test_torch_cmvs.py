"""The port's CMVS (models/cmvs.py, models/gen_option.py, io/bundler.py,
io/ske.py) against the JAX package's, on the CPU.

The same problems, made from numpy seeds, go through both packages.
Tolerances: float32 pair scores, their greedy scores and thresholds
rtol 1e-4, chosen slots exact. The port takes the float32 arccos in
float64 and rounds it; numpy's float32 arccos (SIMD) is up to two ulps
off that, and one ulp of the angle moves the angle score by up to
2 |angle - pivot| / sig2 x ulp, ~1e-5 relative near pi; the first pair
of a selection is compared as a set (see _same_choices). float64 angle
scores, link sums and scalar scores: rtol 1e-12. Clusterings, merged
points and the written files must be equal, byte for byte.
"""
import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu.io import bundler as JB, ske as JS  # noqa: E402
from cmvs_pmvs_tpu.models import cmvs as J  # noqa: E402
from cmvs_pmvs_tpu.models.gen_option import gen_option as jax_gen  # noqa
from cmvs_pmvs_tpu.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_bundle_file, write_pmvs_tree)

from cmvs_pmvs_tpu_torch.convert import cmvs_problem_from_arrays  # noqa
from cmvs_pmvs_tpu_torch.io import bundler as TB, ske as TS  # noqa: E402
from cmvs_pmvs_tpu_torch.models import cmvs as T  # noqa: E402
from cmvs_pmvs_tpu_torch.models.gen_option import gen_option  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import make_ring_bundle  # noqa

RTOL32 = 1e-4
RTOL64 = 1e-12
QUIET = dict(log=lambda *a: None)


def _problems(**kw):
    f = make_ring_bundle(**kw)
    return J.CmvsProblem(**f), cmvs_problem_from_arrays(**f, device="cpu")


@pytest.fixture(scope="module")
def ring():
    """A small ring bundle with thresholds set in both packages."""
    jp, tp = _problems(n_cams=60, n_pts=1500, seed=3)
    a = J.CmvsClustering(jp, maximage=20, **QUIET)
    b = T.CmvsClustering(tp, maximage=20, **QUIET)
    for c in (a, b):
        c.set_vpoints()
        c.set_neighbors()
        c.set_score_thresholds()
    return jp, tp, a, b


def test_angle_score_matches():
    """float64 cosines: rtol 1e-12. float32 cosines: numpy's float32
    arccos and the port's (float64, rounded) differ by at most two ulps
    of the angle, and the exponent -d*d / sig2 (d = angle - pivot) is
    formed from float32 d and d*d; the tolerance is what those move the
    score by: 2 |d| / sig2 x 2 ulp(angle) + 4 x 2^-24 x d^2 / sig2,
    relative, plus 1e-12."""
    rng = np.random.default_rng(0)
    cos = rng.uniform(-1.0, 1.0, 20000)
    cos[:3] = [1.0, np.cos(np.deg2rad(20.0)), 1.0 + 1e-7]
    want = J.angle_score(cos)
    got = T.angle_score(torch.from_numpy(cos)).numpy()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL64, atol=0)

    c32 = cos.astype(np.float32)
    want = J.angle_score(c32)
    got = T.angle_score(torch.from_numpy(c32)).numpy()
    angle = np.arccos(np.minimum(1.0, c32)).astype(np.float64)
    ulps = np.abs(angle.astype(np.float32).view(np.int32).astype(np.int64)
                  - np.arccos(np.minimum(1.0, c32.astype(np.float64)))
                  .astype(np.float32).view(np.int32))
    assert ulps.max() <= 2
    d = np.abs(angle - T.PIVOT)
    sig2 = np.where(angle < T.PIVOT, 2 * T.LSIGMA ** 2, 2 * T.RSIGMA ** 2)
    rel = (2 * d / sig2 * 2 * np.spacing(angle.astype(np.float32))
           + 4 * 2.0 ** -24 * d * d / sig2 + 1e-12)
    assert (np.abs(got - want) <= want * rel).all()
    assert np.mean(got == want) > 0.5


def test_pair_scores_and_score2_match(ring):
    jp, tp, _, _ = ring
    rng = np.random.default_rng(1)
    rows = rng.choice(len(jp.coords), 400, replace=False)
    vis = J.pad_lists([jp.visibles[i] for i in rows])
    vis[rng.random(vis.shape) < 0.2] = -1     # random subsets
    img = np.maximum(vis, 0)
    want = J.pair_scores_batch(jp.centers, jp.ipscales, jp.coords[rows],
                               img, vis >= 0)
    got = T.pair_scores_batch(tp.centers, tp.ipscales, tp.coords[rows],
                              torch.from_numpy(img),
                              torch.from_numpy(vis >= 0)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL32)
    for tau in (2, 4, 6):
        ws, wc = J.score2_batch(jp.centers, jp.ipscales, jp.coords[rows],
                                vis, tau)
        gs, gc = T.score2_batch(tp.centers, tp.ipscales, tp.coords[rows],
                                torch.from_numpy(vis), tau)
        np.testing.assert_allclose(gs.numpy(), ws, rtol=RTOL32)
        _same_choices(gc.numpy(), wc)


def _same_choices(got, want):
    """Chosen slots equal, the first pair as a set: pair[i, j] and
    pair[j, i] are (A * s_i) * s_j and (A * s_j) * s_i, equal but for
    rounding in both packages, so an ulp of A can swap which of the two
    the argmax meets first. Every later step sums both rows, so it is
    exact."""
    assert np.array_equal(np.sort(got[:, :2], 1), np.sort(want[:, :2], 1))
    assert np.array_equal(got[:, 2:], want[:, 2:])


def test_compute_score2_matches(ring):
    jp, _, a, b = ring
    for pid in (0, 5, 77, 400):
        imgs = jp.visibles[pid]
        for sub in (imgs, imgs[:2], imgs[::2], imgs[:1]):
            ws, wu = a.compute_score2(jp.coords[pid], sub)
            gs, gu = b.compute_score2(jp.coords[pid], sub)
            assert gs == pytest.approx(ws, rel=RTOL64)
            _same_choices(np.array([gu]), np.array([wu]))


def test_thresholds_and_link_matrix_match(ring):
    """Thresholds and the link matrix of the whole chain (float32 pair
    scores inside: rtol 1e-4); the link sums alone, given the port's own
    pair cache and thresholds, equal the JAX package's bincount sums
    (rtol 1e-12; they are in fact bit-equal)."""
    jp, _, a, b = ring
    np.testing.assert_allclose(b.score_thresholds, a.score_thresholds,
                               rtol=RTOL32)
    want = [sorted(u) for u in a.uimages]
    got = [sorted(int(i) for i in u if i >= 0) for u in b.uimages]
    assert got == want
    La, Lb = a._link_matrix(), b._link_matrix()
    assert Lb.dtype == np.float64 and La.any()
    np.testing.assert_allclose(Lb, La, rtol=RTOL32, atol=0)
    # the same bits on a second call (fixed summation order)
    assert np.array_equal(b._link_matrix(), Lb)
    # the sums alone: JAX's _link_matrix on the port's cache, thresholds
    c = J.CmvsClustering(jp, maximage=20, **QUIET)
    c._vis_pad, c._pair, c._cache_ok = b.vis_pad, b._pair.numpy(), True
    c.score_thresholds = b.score_thresholds
    Lc = c._link_matrix()
    np.testing.assert_allclose(Lb, Lc, rtol=RTOL64, atol=0)
    assert np.array_equal(Lb, Lc)


def test_segment_sum_is_bincount():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 50, 5000)
    vals = rng.normal(0, 1, 5000) * 10.0 ** rng.uniform(-8, 8, 5000)
    got = T.segment_sum(torch.from_numpy(keys), torch.from_numpy(vals), 60)
    assert np.array_equal(got.numpy(),
                          np.bincount(keys, weights=vals, minlength=60))


def test_merge_sfm_points_matches():
    jp, tp = _problems(n_cams=80, n_pts=3000, seed=5)
    a = J.CmvsClustering(jp, maximage=20, **QUIET)
    b = T.CmvsClustering(tp, maximage=20, **QUIET)
    for c in (a, b):
        c.set_vpoints()
        c.set_neighbors()
        c.set_score_thresholds()
        c.slim_neighbors_set_links()
        c.merge_sfm_points()
    assert len(b.coords) < 3000
    assert np.array_equal(b.coords.numpy(), a.coords)
    assert b.visibles == a.visibles
    assert np.array_equal(b.pweights.numpy(), a.pweights)


@pytest.mark.parametrize("scale,least", [(1.0, 30), (4.0, 1000)])
def test_radius_search_matches_jax_path(scale, least):
    """test_native.py's 3,000 points with radii over two orders of
    magnitude (and 4x those): the same pairs as the JAX package's
    merge-candidate search (and as a brute-force float64 check)."""
    rng = np.random.default_rng(11)
    pts = rng.normal(0, 1, (3000, 3)).astype(np.float32).astype(np.float64)
    radii = scale * (10.0 ** rng.uniform(-2.5, -0.7, 3000)).astype(
        np.float32).astype(np.float64)
    c = J.CmvsClustering(J.CmvsProblem(
        coords=pts, visibles=[[0, 1]] * 3000, centers=np.zeros((2, 3)),
        ipscales=np.ones(2), widths=np.ones(2), heights=np.ones(2)),
        maximage=10, **QUIET)
    adj = c._neighbor_candidates(radii)
    want = {(i, j) for i, n in enumerate(adj) for j in n if i < j}
    got = T.radius_pairs(torch.from_numpy(pts), torch.from_numpy(radii))
    got = [tuple(p) for p in got.tolist()]
    assert got == sorted(got) and len(set(got)) == len(got)
    assert set(got) == want
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    i, j = np.nonzero((d <= radii[:, None]) & (d <= radii[None, :]))
    assert {(a, b) for a, b in zip(i, j) if a < b} == want
    assert len(want) > least


def test_radius_search_batches(monkeypatch):
    """Candidate expansion in batches of a few points gives the same
    pairs as one batch."""
    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.normal(0, 1, (500, 3)))
    radii = torch.from_numpy(rng.uniform(0.2, 0.5, 500))
    whole = T.radius_pairs(pts, radii)
    monkeypatch.setattr(T, "RADIUS_BATCH_PAIRS", 64)
    assert torch.equal(T.radius_pairs(pts, radii), whole)
    assert len(whole) > 100


@pytest.mark.parametrize("cache_bytes", [None, 0])
def test_ring_bundle_clusters_match(cache_bytes):
    """make_bundle(120, 4000, seed 11) at maximage=30: the same
    clustering as the JAX package, with the pair cache on the device and
    (PAIR_CACHE_BYTES = 0) recomputed chunk by chunk."""
    jp, tp = _problems(n_cams=120, n_pts=4000, seed=11)
    a = J.CmvsClustering(jp, maximage=30, **QUIET)
    a.run()
    b = T.CmvsClustering(tp, maximage=30, **QUIET)
    if cache_bytes is not None:
        b.PAIR_CACHE_BYTES = cache_bytes
    b.run()
    assert (b._pair is None) == (cache_bytes == 0)
    assert len(b.timages) >= 2
    assert b.timages == a.timages
    assert np.array_equal(b.removed, a.removed)
    assert b.neighbors == a.neighbors


@pytest.fixture(scope="module")
def cmvs_trees(tmp_path_factory):
    """test_cmvs.py's scene (12 cameras, 160x120, 300 points, maximage=3)
    through both packages' cmvs3 and genOption, each in its own tree."""
    scene = make_plane_scene(num_cameras=12, width=160, height=120,
                             ring_radius=1.5)
    roots = {}
    for name in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(name))
        write_pmvs_tree(scene, root)
        write_bundle_file(scene, root, num_points=300)
        roots[name] = root
    a = J.run_cmvs(roots["jax"], maximage=3, **QUIET)
    b = T.run_cmvs(roots["port"], maximage=3, device="cpu", **QUIET)
    jax_gen(roots["jax"], level=0, csize=2)
    gen_option(roots["port"], level=0, csize=2)
    return roots, a, b


def test_run_cmvs_files_identical(cmvs_trees):
    roots, a, b = cmvs_trees
    assert b.timages == a.timages and len(b.timages) >= 2
    names = sorted(n for n in os.listdir(roots["jax"])
                   if n in ("ske.dat", "vis.dat")
                   or n.startswith("centers-"))
    assert len(names) == len(a.timages) + 2
    assert sorted(n for n in os.listdir(roots["port"])
                  if n in names) == names
    for n in names:
        assert filecmp.cmp(os.path.join(roots["jax"], n),
                           os.path.join(roots["port"], n), shallow=False), n


def test_gen_option_files_identical(cmvs_trees):
    roots, a, _ = cmvs_trees
    names = ["pmvs.sh"] + ["option-%04d" % c for c in range(len(a.timages))]
    for n in names:
        assert filecmp.cmp(os.path.join(roots["jax"], n),
                           os.path.join(roots["port"], n), shallow=False), n


def test_load_problem_matches(cmvs_trees):
    roots, _, _ = cmvs_trees
    jp = J.load_problem(roots["jax"])
    tp = T.load_problem(roots["port"], device="cpu")
    assert np.array_equal(tp.centers.numpy(), jp.centers)
    assert np.array_equal(tp.ipscales.numpy(), jp.ipscales)
    assert np.array_equal(tp.coords.numpy(), jp.coords)
    assert tp.visibles == jp.visibles and tp.dlevel == jp.dlevel
    assert np.array_equal(tp.widths, jp.widths)
    assert np.array_equal(tp.heights, jp.heights)


def test_bundle_and_ske_round_trips(cmvs_trees, tmp_path):
    roots, a, _ = cmvs_trees
    path = os.path.join(roots["port"], "bundle.rd.out")
    jb, tb = JB.read_bundle(path), TB.read_bundle(path)
    for f in ("focals", "distortions", "rotations", "translations",
              "original_ids", "coords", "colors"):
        assert np.array_equal(getattr(tb, f), getattr(jb, f)), f
    assert tb.visibles == jb.visibles and tb.num_points == 300
    # ske: each package reads what the other writes
    out = str(tmp_path / "ske.dat")
    TS.write_ske(out, 12, a.timages, [[1, 2], []] + a.oimages[2:])
    assert JS.read_ske(out) == TS.read_ske(out)
    JS.write_ske(out + "2", 12, a.timages, a.oimages)
    assert TS.read_ske(out + "2") == (12, a.timages, a.oimages)
    assert filecmp.cmp(out + "2", os.path.join(roots["port"], "ske.dat"),
                       shallow=False)

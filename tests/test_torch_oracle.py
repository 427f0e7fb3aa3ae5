"""The port's engine against the sequential reference oracle.

Counterpart of tests/test_oracle.py's two engine tests: the oracle
(tests/oracle_pmvs.py, numpy + scipy, reused as it is) and the port's
engine on the CPU reconstruct the same tiny plane scene from the same
detected features, and the clouds are compared at the aggregate level
(accuracy, covered reference cells, patch count) with the JAX test's
bars unchanged. test_oracle_filters_reject_junk drives the oracle alone,
with no engine in it, so it has no counterpart here.

The oracle's seed and expand run once for the module; each test takes a
deep copy (the filters test runs the oracle's filters on its copy), so
both tests compare the same clouds as the JAX file does.
"""
import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cmvs_pmvs_tpu_torch.models.engine as E  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.detect import detect_features  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

from oracle_pmvs import OraclePMVS  # noqa: E402

W, H, NCAM, FOCAL = 96, 72, 5, 130.0
FEAT_CAP = 48     # strongest features per image fed to BOTH sides


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("oracle"))
    scene = make_plane_scene(num_cameras=NCAM, width=W, height=H,
                             focal=FOCAL)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\n"
                "minImageNum 3\nCPU 4\nsetEdge 0\nuseBound 0\n"
                "useVisData 0\nsequence -1\n"
                f"timages -1 0 {NCAM}\noimages 0\n")
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = E.load_scene(root, opt, device="cpu")

    # one shared feature set for both sides, from the port's detector
    pyr = data.pyr
    h = int(pyr.heights[0].max())
    w = int(pyr.widths[0].max())
    x0 = int(pyr.xoff[0])
    img = pyr.atlas[:, :h, x0:x0 + w, :]
    mask = pyr.mask_atlas[:, :h, x0:x0 + w] \
        * pyr.edge_atlas[:, :h, x0:x0 + w]
    feats = detect_features(img, mask, pyr.widths[0], pyr.heights[0],
                            fcsize=16)
    fx, fy, fr, ft, fv = (feats[k].numpy() for k in
                          ("x", "y", "response", "type", "valid"))
    order = np.argsort(np.where(fv, -fr, np.inf), axis=1)[:, :FEAT_CAP]
    fx, fy, fr, ft, fv = (np.take_along_axis(a, order, axis=1)
                          for a in (fx, fy, fr, ft, fv))
    feats_eng = {k: torch.as_tensor(a) for k, a in
                 zip(("x", "y", "response", "type", "valid"),
                     (fx, fy, fr, ft, fv))}
    feats_orc = [
        [(float(fx[i, k]), float(fy[i, k]), float(fr[i, k]),
          int(ft[i, k])) for k in range(fx.shape[1]) if fv[i, k]]
        for i in range(NCAM)]

    orc = OraclePMVS(list(scene.images), scene.P, csize=opt.csize,
                     wsize=opt.wsize, threshold=opt.threshold,
                     min_image_num=opt.min_image_num)
    orc.run_seed(feats_orc)
    n_seed = len(orc.patches)
    orc.run_expand()
    return scene, data, opt, feats_eng, orc, n_seed


def _metrics(scene, coords, dscales, tn, cams_P, csize):
    """(median plane offset in dscale units, set of covered ref cells)."""
    off = np.abs(scene.plane_distance(coords[:, :3])) / dscales
    covered = set()
    for i in range(tn):
        q = (np.asarray(cams_P)[i] @ np.concatenate(
            [coords[:, :3], np.ones((len(coords), 1))], 1).T)
        ok = q[2] > 0
        x = q[0, ok] / q[2, ok]
        y = q[1, ok] / q[2, ok]
        for cx, cy in zip((x // csize).astype(int),
                          (y // csize).astype(int)):
            covered.add((i, cx, cy))
    return float(np.median(off)), covered


def _oracle_metrics(scene, opt, orc):
    oc = np.stack([p.coord for p in orc.patches])
    od = np.array([p.dscale for p in orc.patches])
    return _metrics(scene, oc, od, orc.tn, scene.P, opt.csize)


def _engine_run(scene, data, opt, feats_eng, monkeypatch, filters):
    eng = E.PMVSEngine(data, opt, p_cap=16384, log=lambda *a: None,
                       device="cpu")
    monkeypatch.setattr(E, "detect_features", lambda *a, **k: feats_eng)
    thr0 = eng.thr
    eng.run(expand_iters=1, max_waves=12, refine_iters=8, filters=filters)
    alive = eng.cloud.alive.numpy()
    ec = eng.cloud.coord.numpy()[alive]
    ed = eng.cloud.dscale.numpy()[alive]
    acc, cov = _metrics(scene, ec, ed, eng.cfg.tn, scene.P, opt.csize)
    return eng, thr0, len(ec), acc, cov


def test_engine_matches_oracle_aggregates(setup, monkeypatch):
    scene, data, opt, feats_eng, orc0, n_seed_orc = setup
    orc = copy.deepcopy(orc0)
    assert n_seed_orc > 10, "oracle seeding produced too few patches"
    n_orc = len(orc.patches)
    assert n_orc > n_seed_orc, "oracle expansion added nothing"
    acc_orc, cov_orc = _oracle_metrics(scene, opt, orc)

    eng, thr0, n_eng, acc_eng, cov_eng = _engine_run(
        scene, data, opt, feats_eng, monkeypatch, filters=False)
    # filters=False skips the filter stage and still relaxes the
    # thresholds after the round, as the JAX engine does
    assert eng.stats == []
    assert float(eng.thr.ncc) == pytest.approx(float(thr0.ncc) - 0.05)
    print(f"[oracle] orc {n_orc} acc {acc_orc:.3f} cov {len(cov_orc)}; "
          f"eng {n_eng} acc {acc_eng:.3f} cov {len(cov_eng)} "
          f"inter {len(cov_eng & cov_orc)}")

    # accuracy: both clouds lie on the plane within a fraction of a
    # depth step; the engine must not be materially worse
    assert acc_orc < 0.35, acc_orc
    assert acc_eng < 0.35, acc_eng
    assert acc_eng < max(2.0 * acc_orc, 0.2), (acc_eng, acc_orc)
    # completeness: covered reference-image cells within 35% of the
    # oracle's, and substantial overlap of the covered sets
    assert len(cov_eng) > 0.65 * len(cov_orc), \
        (len(cov_eng), len(cov_orc))
    inter = len(cov_eng & cov_orc)
    assert inter > 0.55 * len(cov_orc), (inter, len(cov_orc))
    # patch count within a factor 2 (wave dedup keeps one patch per
    # cell per wave; the sequential walk can stack more)
    assert 0.5 * n_orc < n_eng < 2.0 * n_orc, (n_eng, n_orc)


def test_engine_matches_oracle_with_filters(setup, monkeypatch):
    """Seed -> expand -> filters on both sides (the oracle's
    filterOutside + filterNeighbor, the engine's four passes)."""
    scene, data, opt, feats_eng, orc0, _ = setup
    orc = copy.deepcopy(orc0)
    n_pre = len(orc.patches)
    orc.run_filters(quad=opt.quad_threshold)
    n_orc = len(orc.patches)
    assert n_orc > 10, n_orc
    acc_orc, cov_orc = _oracle_metrics(scene, opt, orc)

    eng, _, n_eng, acc_eng, cov_eng = _engine_run(
        scene, data, opt, feats_eng, monkeypatch, filters=True)
    assert len(eng.stats) == 1
    print(f"[oracle-filters] orc {n_pre}->{n_orc} acc {acc_orc:.3f} "
          f"cov {len(cov_orc)}; eng {n_eng} acc {acc_eng:.3f} "
          f"cov {len(cov_eng)} inter {len(cov_eng & cov_orc)}")

    # neither side's filters may gut the cloud (the plane scene has no
    # outliers)
    assert n_orc > 0.6 * n_pre, (n_orc, n_pre)
    # accuracy: surviving clouds sit on the plane
    assert acc_orc < 0.35, acc_orc
    assert acc_eng < 0.35, acc_eng
    assert acc_eng < max(2.0 * acc_orc, 0.2), (acc_eng, acc_orc)
    # completeness
    assert len(cov_eng) > 0.8 * len(cov_orc), \
        (len(cov_eng), len(cov_orc))
    inter = len(cov_eng & cov_orc)
    assert inter > 0.7 * len(cov_orc), (inter, len(cov_orc))
    # count within 1.9x either way (wave dedup vs sequential stacking)
    assert n_orc / 1.9 < n_eng < 1.9 * n_orc, (n_eng, n_orc)

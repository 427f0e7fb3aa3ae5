"""Score-priority commit in the port's expansion wave
(tests/test_priority.py, on the port's CPU path).

The reference drains a priority queue ordered by score2
(expand.cpp:80-88, patchOrganizerS.hpp:10-15), so under contention the
best patches expand first. The port's wave orders its candidates best
score2 first (expand_discover) and `expand_commit` refines the first
`cbudget` of them: with a budget below the candidate count, only
candidates of the top-score2 parents are committed, and the parents of
the rest stay queued for the next wave. On the same seeded state, the
JAX package's expand_discover / expand_commit give the same candidate
rows, take the same parents and requeue the same frontier rows.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cmvs_pmvs_tpu.models import engine as JE  # noqa: E402
from cmvs_pmvs_tpu.models import expand as JX  # noqa: E402
from cmvs_pmvs_tpu.models.config import Thresholds as JThresholds  # noqa
from cmvs_pmvs_tpu.models.grid import GridState as JGridState  # noqa: E402
from cmvs_pmvs_tpu.models.patches import PatchCloud as JPatchCloud  # noqa
from cmvs_pmvs_tpu.utils.options import PMVSOptions as JaxOptions  # noqa
from cmvs_pmvs_tpu.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

from cmvs_pmvs_tpu_torch.models.engine import (  # noqa: E402
    PMVSEngine, load_scene)
from cmvs_pmvs_tpu_torch.models.expand import (  # noqa: E402
    expand_commit, expand_discover)
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402

CBUDGET = 64


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prio"))
    scene = make_plane_scene(num_cameras=5, width=192, height=144,
                             focal=260.0)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                "timages -1 0 5\noimages 0\n")
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt, device="cpu")
    eng = PMVSEngine(data, opt, p_cap=16384, log=lambda *a: None,
                     device="cpu")
    # seed + visibility only: no expansion, and no filters (they would
    # thin the sparse seed set below the contention threshold)
    eng.run(expand_iters=0, refine_iters=6)
    return data, eng, root


def test_small_budget_commits_top_scores(seeded):
    data, eng, _ = seeded
    cloud, grid = eng.cloud, eng.grid
    alive = cloud.alive.numpy()
    n = int(alive.sum())
    disc = expand_discover(data.cams, data.pyr, eng.cfg, eng.thr, cloud,
                           grid, cloud.alive.clone(), slack=0, fbudget=n)
    sval = disc.sval.numpy()
    assert sval.sum() > CBUDGET, f"too few candidates ({sval.sum()})"
    dflag_before = cloud.dflag.numpy().copy()
    cloud2, _, new_frontier, st = expand_commit(
        data.cams, data.pyr, eng.cfg, eng.thr, data.visdata, cloud, grid,
        disc, CBUDGET, refine_iters=4)

    # rank of every frontier row in best-score2-first order
    score = np.where(alive, cloud.score2(eng.thr.ncc).numpy(), -np.inf)
    order = np.argsort(-score, kind="stable")[:n]
    rank = np.full(len(score), len(score))
    rank[order] = np.arange(n)
    parent = disc.parent.numpy()
    pos = np.nonzero(sval)[0]
    taken, left = parent[pos[:CBUDGET]], parent[pos[CBUDGET:]]
    # the committed candidates' parents are the best-ranked ones (the
    # boundary parent may have sectors on both sides of the budget)
    assert rank[taken].max() <= rank[left].min()
    assert len(set(taken)) < len(set(taken) | set(left))

    # a failed sector marks its parent: only committed parents changed
    changed = np.nonzero(cloud2.dflag.numpy()[:len(dflag_before)]
                         != dflag_before)[0]
    assert int(st.accepted) + len(changed) > 0, "wave processed nothing"
    assert set(changed.tolist()) <= set(taken.tolist())

    # the parents of candidates beyond the budget stay queued
    nf = new_frontier.numpy()
    assert nf[np.unique(left)].all()


def _to_jax(cls, x):
    """The JAX package's `cls` holding the port's state `x`."""
    return cls(**{f.name: jnp.asarray(getattr(x, f.name).numpy())
                  for f in dataclasses.fields(x)})


def test_budget_commit_matches_jax(seeded):
    """The port's seeded cloud, grid and thresholds carried into the JAX
    package: its discover at the same fbudget (the whole frontier) gives
    the same candidate rows, and its commit under the
    same cbudget takes the same parents and requeues the same rows."""
    data, eng, root = seeded
    cloud, grid = eng.cloud, eng.grid
    alive = cloud.alive.numpy()
    n = int(alive.sum())
    jopt = JaxOptions.parse(os.path.join(root, "option.txt"))
    jdata = JE.load_scene(root, jopt)
    jcfg = JE.PMVSEngine(jdata, jopt, p_cap=eng.p_cap,
                         log=lambda *a: None).cfg
    jcloud = _to_jax(JPatchCloud, cloud)
    jgrid = _to_jax(JGridState, grid)
    jthr = _to_jax(JThresholds, eng.thr)

    disc = expand_discover(data.cams, data.pyr, eng.cfg, eng.thr, cloud,
                           grid, cloud.alive.clone(), slack=0, fbudget=n)
    jdisc = JX.expand_discover(jdata.cams, jdata.pyr, jcfg, jthr, jcloud,
                               jgrid, jcloud.alive, slack=0, fbudget=n)
    parent, sval = disc.parent.numpy(), disc.sval.numpy()
    np.testing.assert_array_equal(parent, np.asarray(jdisc.parent))
    np.testing.assert_array_equal(sval, np.asarray(jdisc.sval))
    assert sval.sum() > CBUDGET and not np.asarray(jdisc.overflow).any()

    _, _, nf, st = expand_commit(data.cams, data.pyr, eng.cfg, eng.thr,
                                 data.visdata, cloud, grid, disc, CBUDGET,
                                 refine_iters=4)
    _, _, jnf, jst = JX.expand_commit(jdata.cams, jdata.pyr, jcfg, jthr,
                                      jdata.visdata, jcloud, jgrid, jdisc,
                                      CBUDGET, refine_iters=4)
    pos = np.nonzero(sval)[0]
    jpos = np.nonzero(np.asarray(jdisc.sval))[0]
    np.testing.assert_array_equal(
        parent[pos[:CBUDGET]], np.asarray(jdisc.parent)[jpos[:CBUDGET]])
    # the seeded rows left on the frontier: the parents requeued
    nf, jnf = nf.numpy(), np.asarray(jnf)
    assert nf[alive].sum() > 0
    np.testing.assert_array_equal(nf[alive], jnf[alive])
    na, nja = int(st.accepted), int(jst.accepted)
    assert na > 0 and abs(na - nja) <= max(2, 0.1 * nja), (na, nja)

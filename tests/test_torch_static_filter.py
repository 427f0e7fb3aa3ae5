"""The filter stage's static-shape programs in the port, on its CPU path,
against the JAX package's (cmvs_pmvs_tpu/models/grid.py:286-352,
filter.py:252-678) on the same state.

The state: the port's engine on a 5-camera 160x120 plane scene after
its seed and one expand round (no filters), carried into the JAX
package as in tests/test_torch_priority.py. Exact: `window_pairs` at a
budget at or above the pair count and below it (pairs dropped, also in
its first stage), `count_neighbor_pairs` and `count_neighbor_pairs_rows`.
Verdicts (`filter_neighbor_rows`, `run_filters_pre` / `post` / `tail`)
agree with JAX's on >= 98% of rows and their stats within 2%
(tests/test_torch_models.py's bar: the quadric moments sum in another
order), and equal the port's own single pass exactly, as does
`filter_neighbor_chunked` (three chunks and more, the halve-and-retry
rule among them). `filter_small_groups`' fixed rounds give the labels of
an early-exit loop.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cmvs_pmvs_tpu.models import engine as JE  # noqa: E402
from cmvs_pmvs_tpu.models import filter as JF  # noqa: E402
from cmvs_pmvs_tpu.models import grid as JG  # noqa: E402
from cmvs_pmvs_tpu.models.config import Thresholds as JThresholds  # noqa
from cmvs_pmvs_tpu.models.grid import GridState as JGridState  # noqa: E402
from cmvs_pmvs_tpu.models.patches import PatchCloud as JPatchCloud  # noqa
from cmvs_pmvs_tpu.utils.options import PMVSOptions as JaxOptions  # noqa
from cmvs_pmvs_tpu.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

from cmvs_pmvs_tpu_torch.models import filter as TF  # noqa: E402
from cmvs_pmvs_tpu_torch.models import grid as TG  # noqa: E402
from cmvs_pmvs_tpu_torch.models.engine import (  # noqa: E402
    PMVSEngine, load_scene)
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402

AGREE = 0.98


def _to_jax(cls, x):
    return cls(**{f.name: jnp.asarray(getattr(x, f.name).numpy())
                  for f in dataclasses.fields(x)})


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """The port's engine state before its first filter stage and the
    JAX package's scene, config and the same state."""
    root = str(tmp_path_factory.mktemp("static_filter"))
    write_pmvs_tree(make_plane_scene(num_cameras=5, width=160, height=120,
                                     focal=200.0), root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                "timages -1 0 5\noimages 0\n")
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt, device="cpu")
    eng = PMVSEngine(data, opt, p_cap=4096, log=lambda *a: None,
                     device="cpu")
    eng.run(expand_iters=1, max_waves=2, refine_iters=2, filters=False)
    n = int(eng.cloud.count())
    assert n > 1500
    jopt = JaxOptions.parse(os.path.join(root, "option.txt"))
    jdata = JE.load_scene(root, jopt)
    jcfg = JE.PMVSEngine(jdata, jopt, p_cap=eng.p_cap,
                         log=lambda *a: None).cfg
    # the filter stage's slice (the prefix bucket holding the alive
    # rows), every 7th alive patch moved 3 dscale along its normal so
    # that the passes have outliers to reject
    cloud = eng._slice(eng._cap_bucket(n))
    off = torch.zeros(cloud.capacity)
    off[:n:7] = 3.0
    cloud = dataclasses.replace(cloud, coord=cloud.coord + (
        off * cloud.dscale)[:, None] * cloud.normal)
    eng.cloud = dataclasses.replace(eng.cloud, coord=torch.cat(
        [cloud.coord, eng.cloud.coord[cloud.capacity:]]))
    return dict(eng=eng, data=data, cfg=eng.cfg, thr=eng.thr, cloud=cloud,
                grid=eng.grid, jdata=jdata, jcfg=jcfg,
                jthr=_to_jax(JThresholds, eng.thr),
                jcloud=_to_jax(JPatchCloud, cloud),
                jgrid=_to_jax(JGridState, eng.grid))


def _tables(s):
    cfg, cloud = s["cfg"], s["cloud"]
    tab = TG.build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    key, ok = TF._neighbor_query_keys(cfg, cloud, tab.sentinel)
    jtab = JG.build_cell_table(s["jcloud"], cfg.tn, cfg.gh, cfg.gw,
                               merged=True)
    jkey, jok = JF._neighbor_query_keys(s["jcfg"], s["jcloud"],
                                        jtab.sentinel)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(tab.pid.numpy(), np.asarray(jtab.pid))
    return tab, key, ok, jtab, jkey, jok


def test_window_pairs_at_budgets_exact(state):
    """At, above and below the pair count, and below the non-empty slot
    count (stage 1 drops): the valid pairs, their rows and entries and
    the dropped count equal JAX's."""
    cfg = state["cfg"]
    tab, key, ok, jtab, jkey, jok = _tables(state)
    need = int(TG.count_window_pairs(tab, key, ok, cfg.cell_k))
    assert need == int(JG.count_window_pairs(jtab, jkey, jok, cfg.cell_k))
    slots = int((ok & (tab.cnt[key.clamp(0, tab.sentinel - 1)] > 0)).sum())
    assert need > slots > 1000
    for budget in (need, need - 1, slots // 2):
        rows, eidx, valid, dropped = TG.window_pairs(tab, key, ok, budget,
                                                     cfg.cell_k)
        jrows, jeidx, jvalid, jdropped = JG.window_pairs(
            jtab, jkey, jok, budget, cfg.cell_k)
        v = valid.numpy()
        np.testing.assert_array_equal(v, np.asarray(jvalid))
        np.testing.assert_array_equal(rows.numpy()[v], np.asarray(jrows)[v])
        np.testing.assert_array_equal(eidx.numpy()[v], np.asarray(jeidx)[v])
        assert int(dropped) == int(jdropped) == max(need - int(v.sum()), 0)
        assert (int(dropped) > 0) == (budget < need), budget


def test_pair_counts_exact(state):
    cfg, jcfg, cloud, jcloud = (state["cfg"], state["jcfg"], state["cloud"],
                                state["jcloud"])
    need = int(TF.count_neighbor_pairs(cfg, cloud))
    assert need == int(JF.count_neighbor_pairs(jcfg, jcloud)) > 0
    p = cloud.capacity
    parts = 0
    for row0, pc in ((0, 1024), (1024, 1024), (512, 1024), (0, p)):
        got = int(TF.count_neighbor_pairs_rows(
            cfg, cloud, torch.tensor(row0), pc))
        assert got == int(JF.count_neighbor_pairs_rows(jcfg, jcloud, row0,
                                                       pc=pc)), (row0, pc)
        parts += got if pc == 1024 and row0 % 1024 == 0 else 0
    assert parts == need


def _budget(need):
    return max(1024, need)


def test_filter_neighbor_rows_vs_single_pass_and_jax(state):
    cams, cfg, thr, cloud = (state["data"].cams, state["cfg"], state["thr"],
                             state["cloud"])
    need = int(TF.count_neighbor_pairs(cfg, cloud))
    single, dropped = TF.filter_neighbor(cams, cfg, thr, cloud, None, need)
    assert int(dropped) == 0
    killed = (cloud.alive & ~single.alive).numpy()
    assert 0 < killed.sum() < cloud.alive.numpy().sum()
    jc, jcfg = state["jdata"].cams, state["jcfg"]
    for row0, pc in ((0, 1024), (1024, 1024)):
        cnt = int(TF.count_neighbor_pairs_rows(cfg, cloud,
                                               torch.tensor(row0), pc))
        rej, dr = TF.filter_neighbor_rows(cams, cfg, thr, cloud,
                                          torch.tensor(row0), pc,
                                          _budget(cnt))
        assert int(dr) == 0
        np.testing.assert_array_equal(rej.numpy(), killed[row0:row0 + pc])
        jrej, jdr = JF.filter_neighbor_rows(
            jc, jcfg, state["jthr"], state["jcloud"], row0, pc=pc,
            pair_budget=_budget(cnt))
        assert int(jdr) == 0
        assert (rej.numpy() == np.asarray(jrej)).mean() >= AGREE
    # a budget short of the need drops pairs and says so
    _, short = TF.filter_neighbor(cams, cfg, thr, cloud, None, need // 2)
    assert int(short) == need - need // 2


def test_chunked_equals_single_pass(state):
    """At the full 4096-row capacity: target chunks of 1024 rows (four,
    two of them dead rows), and a 2048-row first chunk past `max_pairs`
    that is halved and retried."""
    eng = state["eng"]
    cams, cfg, thr, cloud = (state["data"].cams, state["cfg"], state["thr"],
                             eng.cloud)
    need = int(TF.count_neighbor_pairs(cfg, cloud))
    single, _ = TF.filter_neighbor(cams, cfg, thr, cloud, None, need)
    for total, max_pairs, chunks in ((need, need // 8, 4),
                                     (need * 3 // 4, need * 3 // 4, 4)):
        reads = []

        def read(v):
            reads.append(int(v))
            return reads[-1]

        out, dropped = TF.filter_neighbor_chunked(
            cams, cfg, thr, cloud, total, max_pairs=max_pairs, read=read)
        assert int(dropped) == 0
        assert len(reads) == chunks, reads
        if max_pairs > need // 8:
            # the 2048-row first span holds every pair: halved, retried
            assert reads[0] == need > max_pairs >= reads[1], reads
        np.testing.assert_array_equal(out.alive.numpy(),
                                      single.alive.numpy())


def _stats(stats):
    return {k: tuple(int(x) for x in v) for k, v in stats.items()}


def test_staged_filters_vs_jax_and_each_other(state):
    """pre -> count -> post against JAX's programs; pre -> chunked ->
    tail and the run_filters driver against pre -> post, exactly."""
    cams, pyr = state["data"].cams, state["data"].pyr
    cfg, thr, cloud, grid = (state["cfg"], state["thr"], state["cloud"],
                             state["grid"])
    c1, g1, st = TF.run_filters_pre(cams, pyr, cfg, thr, cloud, grid)
    need = int(TF.count_neighbor_pairs(cfg, c1))
    c2, g2, st2 = TF.run_filters_post(cams, pyr, cfg, thr, c1, g1,
                                      _budget(need))
    st = _stats({**st, **st2})
    assert st.pop("pairs_dropped") == (0, 0)
    assert all(a >= b for a, b in st.values())
    assert st["outside"][0] - st["groups"][1] > 0

    jc, jp, jcfg, jthr = (state["jdata"].cams, state["jdata"].pyr,
                          state["jcfg"], state["jthr"])
    j1, jg1, jst = JF.run_filters_pre(jc, jp, jcfg, jthr, state["jcloud"],
                                      state["jgrid"])
    jneed = int(JF.count_neighbor_pairs(jcfg, j1))
    j2, _, jst2 = JF.run_filters_post(jc, jp, jcfg, jthr, j1, jg1,
                                      _budget(jneed))
    jst = _stats({**jst, **jst2})
    assert jst.pop("pairs_dropped") == (0, 0)
    assert abs(need - jneed) <= 0.02 * jneed
    for k, (a, b) in st.items():
        ja, jb = jst[k]
        assert abs(a - ja) <= max(2, 0.02 * ja) and \
            abs(b - jb) <= max(2, 0.02 * jb), (k, st, jst)
    for mine, theirs in ((c1, j1), (c2, j2)):
        assert (mine.alive.numpy() == np.asarray(theirs.alive)).mean() \
            >= AGREE

    # the chunked neighbour pass and the tail give the single pass's bits
    n0 = c1.count()
    c3, dropped = TF.filter_neighbor_chunked(cams, cfg, thr, c1, need,
                                             max_pairs=need // 4)
    n1 = c3.count()
    c3, g3, st3 = TF.run_filters_tail(cams, pyr, cfg, thr, c3, g1)
    assert int(dropped) == 0
    assert _stats({"neighbor": (n0, n1), **st3}) == {
        k: st[k] for k in ("neighbor", "groups")}
    for f in dataclasses.fields(c2):
        assert torch.equal(getattr(c2, f.name), getattr(c3, f.name)), f.name
    for f in dataclasses.fields(g2):
        assert torch.equal(getattr(g2, f.name), getattr(g3, f.name)), f.name

    c4, g4, st4 = TF.run_filters(cams, pyr, cfg, thr, cloud, grid)
    st4 = _stats(st4)
    assert st4.pop("pairs_dropped") == (0, 0)
    assert st4 == st
    assert torch.equal(c4.alive, c2.alive) and torch.equal(c4.coord, c2.coord)


def _early_exit_labels(mn, qn, alive):
    """filterSmallGroups' labels by the loop that stops at its fixpoint
    (the port's before its rounds moved onto the device)."""
    p = alive.shape[0]
    rows = torch.arange(p)
    label = torch.where(alive, rows, torch.full_like(rows, p))
    for _ in range(TF.PROP_ITERS):
        nl = torch.where(mn, label[qn], torch.full_like(qn, p)).amin(1)
        nl = torch.minimum(label, nl)
        nl = torch.minimum(nl, torch.cat([nl, nl.new_tensor([p])])[nl])
        changed = bool((nl != label).any())
        label = nl
        if not changed:
            break
    return label


def test_small_groups_labels_equal_an_early_exit_loop(state):
    """On the state's neighbour graph, and on a chain of 300 rows whose
    fixpoint takes many rounds: the same labels."""
    cams, cfg, thr, cloud = (state["data"].cams, state["cfg"], state["thr"],
                             state["cloud"])
    mn, qn = TF._group_graph(cams, cfg, thr, cloud)
    got = TF.component_labels(mn, qn, cloud.alive)
    np.testing.assert_array_equal(got.numpy(),
                                  _early_exit_labels(mn, qn,
                                                     cloud.alive).numpy())
    assert len(np.unique(got.numpy()[cloud.alive.numpy()])) > 1
    p = 300
    qn = torch.stack([torch.arange(p) - 1, torch.arange(p) + 1], 1).clamp(
        0, p - 1)
    mn = torch.ones((p, 2), dtype=torch.bool)
    alive = torch.ones(p, dtype=torch.bool)
    alive[150] = False
    mn[150] = mn[149, 1] = mn[151, 0] = False
    got = TF.component_labels(mn, qn, alive)
    np.testing.assert_array_equal(got.numpy(),
                                  _early_exit_labels(mn, qn, alive).numpy())
    assert set(got.numpy().tolist()) == {0, 151, p}
    # small groups: the port's pass against JAX's on the state
    out = TF.filter_small_groups(cams, cfg, thr, cloud, None)
    jout = JF.filter_small_groups(state["jdata"].cams, state["jcfg"],
                                  state["jthr"], state["jcloud"], None)
    assert (out.alive.numpy() == np.asarray(jout.alive)).mean() >= AGREE

"""The port's run-and-diagnose drivers (cmvs_pmvs_tpu_torch/scripts:
profile_wave, profile_e2e, run_full, verify_e2e, bench_fan2, ab_broyden)
on the CPU, against the JAX package's functions that the JAX scripts
call (the JAX scripts themselves run at import or need a TPU).

Sizes are small: the refine wave at 64 patches and 2 iterations on a
160x120 plane scene; verify_e2e's plane scene at 96x72 (its patch bar
scaled by the pixel count), where one JAX `reconstruct` serves as the
reference of verify_e2e and of profile_e2e's call counts; run_full on
a 5-camera 96x72 occluded scene. Tolerances as stated per test.
"""
import contextlib
import dataclasses
import importlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cmvs_pmvs_tpu.models.engine as jengine  # noqa: E402
import cmvs_pmvs_tpu.models.seed as jseed  # noqa: E402
import cmvs_pmvs_tpu.ops.refine as JR  # noqa: E402
from cmvs_pmvs_tpu.geom import build_camera_set as jax_cameras  # noqa: E402
from cmvs_pmvs_tpu.image import build_pyramids as jax_pyramids  # noqa

import cmvs_pmvs_tpu_torch.models.engine as port_engine  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import kernels, refine  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.fan import (  # noqa: E402
    TILE_PX, incc_fan_v1, window_positions)
from cmvs_pmvs_tpu_torch.ops.fan2 import incc_fan  # noqa: E402
from cmvs_pmvs_tpu_torch.scripts import (  # noqa: E402
    ab_broyden, bench_fan2, profile_e2e, profile_wave, run_full,
    verify_e2e)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX script's sub-pass names (scripts/profile_e2e.py:104-118)
SUBPASSES = ["refresh_visibility", "filter_outside", "filter_exact",
             "filter_neighbor", "filter_small_groups"]
COUNTED = ("seed_discover", "seed_commit", "expand_discover",
           "expand_commit")


@pytest.fixture(scope="module")
def wave():
    return profile_wave.make_wave(64, width=160, height=120, focal=200.0,
                                  device="cpu")


def test_wave_matches_jax_refine(wave):
    """profile_wave's wave (the CPU's central-difference LM) against the
    JAX refine_patches on its CPU path from the same inputs, with
    test_torch_fan.py's central-LM bar: >= 95% of patches within 1e-2
    dscale (and of a unit normal) of each other."""
    w = wave
    b, t = w.coord0.shape[0], w.cams.P.shape[0]
    coord0, normal = w.coord0.numpy(), w.normal.numpy()
    dscale = w.dscale.numpy()
    tc, tn, _ = profile_wave.run_wave(w, num_iters=2)
    jc = jax_cameras(w.scene.P, dtype=jnp.float32)
    jp = jax_pyramids(list(w.scene.images), None, num_levels=3)
    views = np.tile(np.arange(t, dtype=np.int32)[None], (b, 1))
    jprob = JR.make_problem(jc, 0, jnp.asarray(coord0), jnp.asarray(normal),
                            jnp.asarray(views), jnp.ones((b, t), bool),
                            jnp.asarray(dscale), 3)
    JR.USE_PALLAS_INCC = False
    try:
        jcoord, jnormal = jax.jit(lambda c, n: JR.refine_patches(
            jc, jp, 0, 7, jprob, c, n, num_iters=2)[:2])(
            jnp.asarray(coord0), jnp.asarray(normal))
    finally:
        JR.USE_PALLAS_INCC = None
    dc = np.linalg.norm(tc.numpy()[:, :3] - np.asarray(jcoord)[:, :3],
                        axis=1) / dscale
    dn = np.linalg.norm(tn.numpy()[:, :3] - np.asarray(jnormal)[:, :3],
                        axis=1)
    assert (dc <= 1e-2).mean() >= 0.95, np.sort(dc)[-5:]
    assert (dn <= 1e-2).mean() >= 0.95, np.sort(dn)[-5:]
    # not a trivial agreement: a third of the patches move in 2 steps
    moved = np.linalg.norm(tc.numpy()[:, :3] - coord0[:, :3], axis=1)
    assert (moved > 0).mean() > 0.25


def test_kernel_ab_variants(wave):
    out = ab_broyden.kernel_ab(device="cpu", wave=wave, repeats=1,
                               log=lambda *a: None)
    assert list(out) == [v[0] for v in ab_broyden.VARIANTS]
    for r in out.values():
        assert np.isfinite([r["median_offset_dscale"], r["median_ncc"],
                            r["refinements_per_sec"]]).all()
    assert refine.BROYDEN_REFRESH == 2


def test_ab_broyden_restores_refresh_after_an_exception(monkeypatch, wave):
    seen = []

    def fail(w, num_iters):
        seen.append(refine.BROYDEN_REFRESH)
        raise RuntimeError("wave failed")

    monkeypatch.setattr(profile_wave, "run_wave", fail)
    variants = ab_broyden.VARIANTS
    for first in range(len(variants)):
        monkeypatch.setattr(ab_broyden, "VARIANTS", variants[first:])
        with pytest.raises(RuntimeError, match="wave failed"):
            ab_broyden.kernel_ab(device="cpu", wave=wave)
        assert refine.BROYDEN_REFRESH == 2
    assert seen == [2, 2, 1]


# initial patch capacity of the plane runs (the engines grow it as
# needed): the port's filters sweep the whole capacity, slow on a CPU
P_CAP = 2000


@pytest.fixture(scope="module")
def plane_runs(tmp_path_factory):
    """One scene, three trees: the JAX reconstruct with its engine's
    seed/expand functions counted, verify_e2e's check, profile_e2e's
    profile at the same depth with the first filter stage profiled."""
    roots = {k: str(tmp_path_factory.mktemp(k))
             for k in ("jax", "verify", "profile")}
    scene = verify_e2e.write_tree(roots["jax"], 96, 72)
    for k in ("verify", "profile"):
        verify_e2e.write_tree(roots[k], 96, 72)
    counts = dict.fromkeys(COUNTED, 0)
    mp = pytest.MonkeyPatch()
    for mod, names in ((jseed, COUNTED[:2]), (jengine, COUNTED[2:])):
        for name in names:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, **k):
                counts[_name] += 1
                return _fn(*a, **k)
            mp.setattr(mod, name, counted)
    try:
        jeng = jengine.reconstruct(roots["jax"], "option.txt", p_cap=P_CAP,
                                   expand_iters=1, max_waves=2,
                                   refine_iters=8, log=lambda *a: None)
    finally:
        mp.undo()
    alive = np.asarray(jeng.cloud.alive)
    jmed = float(np.median(
        scene.plane_distance(np.asarray(jeng.cloud.coord)[alive][:, :3])
        / np.asarray(jeng.cloud.dscale)[alive]))
    ver = verify_e2e.check(roots["verify"], scene, "cpu", p_cap=P_CAP)
    prof = profile_e2e.profile(
        roots["profile"], dataclasses.replace(profile_e2e.SMALL, p_cap=P_CAP),
        "cpu", profile_phases=("filter",))
    return dict(jax=jeng, jax_n=int(alive.sum()), jax_median=jmed,
                jax_counts=counts, verify=ver, profile=prof)


def test_verify_matches_jax_reconstruct(plane_runs):
    """test_torch_pipeline.py's bars: counts within 10%, both medians of
    plane distance / dscale < 0.3."""
    r, nj = plane_runs["verify"], plane_runs["jax_n"]
    assert nj > 300 and abs(r["patches"] - nj) <= 0.1 * nj, \
        (r["patches"], nj)
    assert r["median_offset"] < 0.3 and plane_runs["jax_median"] < 0.3


def test_verify_passes(plane_runs):
    r = plane_runs["verify"]
    assert r["verify"] == "PASS" and r["patches"] > r["min_patches"]
    assert {"option.txt.patch", "option.txt.ply"} <= set(r["models"])
    line = json.loads(json.dumps(r))
    assert set(line) == {"verify", "patches", "median_offset", "models",
                         "min_patches"}


def test_profile_e2e_counts_match_jax_phases(plane_runs):
    """profile_e2e at verify_e2e's depth (expand_iters 1, max_waves 2)
    wraps the same seed/expand functions the JAX engine calls, as often;
    every span of the JAX engine is the port's, as often, and the port's
    own spans (the refresh, the steps inside expand and filter) are
    there."""
    p, jeng = plane_runs["profile"], plane_runs["jax"]
    calls = {k: n for k, (_, n) in p["functions"].items()}
    assert set(calls) == set(COUNTED) | {
        "refresh_visibility", "run_filters_pre", "count_neighbor_pairs",
        "run_filters_post"}
    assert {k: calls[k] for k in COUNTED} == plane_runs["jax_counts"]
    jspans = {k: v["count"] for k, v in jeng.tracer.report().items()}
    counts = p["phase_counts"]
    assert {k: counts.get(k) for k in jspans} == jspans
    assert set(counts) - set(jspans) == {
        "refresh", "expand.discover", "expand.commit", "filter.pre",
        "filter.post"}
    assert counts["refresh"] == 1
    assert counts["expand.discover"] == counts["expand"] \
        >= counts["expand.commit"] >= 1
    assert counts["filter.pre"] == counts["filter.post"] == counts["filter"]
    assert set(p["phases"]) == {"detect", "seed", "refresh", "expand",
                                "filter"}
    for name in ("run_filters_pre", "count_neighbor_pairs",
                 "run_filters_post"):
        assert calls[name] == jspans["filter"] == 1, name
    # once after seeding, then before the four passes and after each
    assert calls["refresh_visibility"] == 1 + 5 * jspans["filter"]
    assert p["patches"] > 0 and all(s > 0 for s, _ in
                                    p["functions"].values())


def test_profile_e2e_subpasses_and_restores_the_modules(plane_runs):
    p = plane_runs["profile"]
    assert list(p["subpasses"]) == SUBPASSES
    assert all(s > 0 for s in p["subpasses"].values())
    assert p["device"] == "cpu"
    for modname, names in profile_e2e.TIMED + profile_e2e.MARKED:
        mod = importlib.import_module(f"cmvs_pmvs_tpu_torch.{modname}")
        for name in names:
            assert not hasattr(getattr(mod, name), "__wrapped__"), name


def test_profile_e2e_profile_phase(plane_runs):
    """--profile-phase filter on the CPU: the first filter span and its
    nested ranges captured, no device ops."""
    r = plane_runs["profile"]
    assert list(r["profile"]) == ["filter"]
    s = r["profile"]["filter"]["spans"]
    assert s["filter"]["instances"] == 1 \
        and s["run_filters_pre"]["instances"] == 1 \
        and s["run_filters_post"]["instances"] == 1 \
        and s["refresh_visibility"]["instances"] == 5
    assert "expand" not in s and "seed" not in s
    assert r["profile"]["filter"]["device_ops"] == 0
    assert s["filter"]["busy_share"] == 0.0
    assert "span run_filters_post" in profile_e2e.report(r)


def test_profile_e2e_whole_run_is_profiled_alone(tmp_path):
    with pytest.raises(ValueError, match="alone"):
        profile_e2e.profile(str(tmp_path), profile_e2e.SMALL, "cpu",
                            profile_phases=("run", "seed"))


TINY = profile_e2e.Setup(5, 96, 72, 150.0, 0, 0.0, 1, 1, 8, P_CAP)
KEYS = {"card", "device", "protocol", "load_seconds", "patches",
        "cold_patches", "cold_seconds", "steady_seconds", "patches_per_sec",
        "cold_phase_seconds", "phase_seconds", "launches", "cold_graphs",
        "graphs", "median", "q90", "bars"}


def bench_files():
    return {n: os.stat(os.path.join(ROOT, n)).st_mtime_ns
            for n in os.listdir(ROOT)
            if n.startswith("BENCH") or n == "run_full.json"}


# a count left on K1's counter by whoever counts around run_full
OUTSIDE = 7


@pytest.fixture(scope="module")
def run_full_main(tmp_path_factory):
    """run_full's main on a tiny scene, once, with K1's counter at OUTSIDE
    before the call: its return code, printed line, --out file, temp
    directory, the BENCH files at the root before and after, K1's
    counter after, and the `graphs` argument of each engine it built."""
    tmp_path = tmp_path_factory.mktemp("run_full")
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    k1 = kernels.entries()["incc_fan"]
    saved = k1.launches
    k1.launches = OUTSIDE
    before = bench_files()
    out = tmp_path / "out" / "run_full.json"
    printed = io.StringIO()
    made = []

    class Recorded(port_engine.PMVSEngine):
        def __init__(self, *a, graphs=None, **k):
            made.append(graphs)
            super().__init__(*a, graphs=graphs, **k)

    try:
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(printed):
            mp.setattr(port_engine, "PMVSEngine", Recorded)
            mp.setattr(run_full, "FULL", TINY)
            mp.setattr("tempfile.tempdir", str(tmp))
            rc = run_full.main(["--device", "cpu", "--out", str(out)])
        after = k1.launches
    finally:
        k1.launches = saved
    return dict(rc=rc, line=printed.getvalue().strip().splitlines()[-1],
                out=out, tmp=tmp, bench_before=before,
                bench_after=bench_files(), k1_after=after, graphs=made)


def test_run_full_writes_one_line_to_out_only(run_full_main):
    """run_full on a tiny scene: the printed line is the file at --out,
    every key present; nothing else is written: its tree under the temp
    directory is removed, and no BENCH_*.json at the repository's root
    is added or touched."""
    m = run_full_main
    line, out, tmp = m["line"], m["out"], m["tmp"]
    assert out.read_text() == line + "\n"
    r = json.loads(line)
    assert set(r) == KEYS
    assert set(r["bars"]) == {"patches", "median", "q90", "ok"}
    assert m["rc"] == (0 if r["bars"]["ok"] else 1)
    assert not r["bars"]["patches"]          # far below 80,000 here
    assert r["card"] == "cpu" and r["launches"] == {}
    assert set(r["phase_seconds"]) == {"detect", "seed", "refresh", "expand",
                                       "filter"}
    assert r["median"] < 0.4 and r["patches"] > 0
    assert os.listdir(tmp) == [] and os.listdir(out.parent) == \
        ["run_full.json"]
    assert m["bench_after"] == m["bench_before"]


def test_run_full_runs_without_graphs_on_the_cpu(run_full_main):
    """On the CPU the cold engine makes no graph cache, so the warm
    engine, which takes the cold engine's, gets None too."""
    assert run_full_main["graphs"] == [None, None]
    r = json.loads(run_full_main["line"])
    assert r["cold_graphs"] is None and r["graphs"] is None


def test_run_full_leaves_the_launch_counters_alone(run_full_main):
    """A count on a kernel's counter before run_full is still there after
    it (a caller counting around run_full reads every launch), and is
    not reported as run_full's own: its launches are a difference."""
    assert run_full_main["k1_after"] == OUTSIDE
    assert json.loads(run_full_main["line"])["launches"] == {}


def test_launches_since_counts_without_resetting():
    """kernels.launches_since reports what launched since a snapshot,
    and neither it nor launch_counts writes a counter."""
    es = kernels.entries()
    k1, k2 = es["incc_fan"], es["windows"]
    saved = k1.launches, k2.launches
    try:
        before = kernels.launch_counts()
        k1.launches += 3
        assert kernels.launches_since(before) == {"incc_fan": 3}
        k2.launches += 1
        assert kernels.launches_since(before) == {"incc_fan": 3,
                                                  "windows": 1}
        assert (k1.launches, k2.launches) == (saved[0] + 3, saved[1] + 1)
        assert set(kernels.launch_counts()) == set(kernels.ENTRIES)
    finally:
        k1.launches, k2.launches = saved


def test_run_full_card_without_nvidia_smi(monkeypatch):
    def absent():
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(run_full.ablate_common, "card", absent)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: "GPU X")
    assert run_full.card(torch.device("cuda")) == \
        "GPU X (power limit not read: no nvidia-smi)"
    assert run_full.card(torch.device("cpu")) == "cpu"


def test_bench_fan2_taps_stay_inside_their_tiles():
    """bench_fan2 holds K3 to K1 because every tap of its frames lies in
    its pair's tile and the atlas; on the CPU their plain versions
    agree."""
    rng = np.random.default_rng(0)
    pairs = bench_fan2.make_pairs(rng, batch=16)
    org = pairs["tile_org"]
    for fan in (4, 1):
        f = bench_fan2.make_frames(org, fan, rng)
        x, y = window_positions(torch.from_numpy(f["frames"]), 7)
        x, y = x.numpy(), y.numpy()
        ox = org[:, :, None, None, 0]
        oy = org[:, :, None, None, 1]
        assert (x >= ox).all() and (np.floor(x) + 1 < ox + TILE_PX).all()
        assert (y >= oy).all() and (np.floor(y) + 1 < oy + TILE_PX).all()
        n, h, wa, _ = pairs["atlas"].shape
        assert (np.floor(x) + 1 < wa).all() and (np.floor(y) + 1 < h).all()
        t = {k: torch.from_numpy(v) for k, v in {**pairs, **f}.items()}
        v1 = incc_fan_v1(t["atlas"], t["vid"], t["tile_org"], t["frames"],
                         t["ok"], 7)
        v2 = incc_fan(t["atlas"], t["vid"], t["frames"], t["ok"], 7)
        assert float((v1 - v2).abs().max()) <= 1e-6


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_bench_fan2_needs_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_fan2.bench(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_fan2.bench(device="cpu")


def test_profile_wave_capture_needs_cuda(no_cuda, wave):
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_wave.capture(device="cuda", wave=wave)


@pytest.mark.parametrize("driver", [profile_wave, profile_e2e, run_full,
                                    verify_e2e, bench_fan2, ab_broyden])
def test_drivers_default_to_cuda(no_cuda, driver, tmp_path):
    """Every driver's main runs on CUDA unless told otherwise, and raises
    without it before doing any work."""
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["--out", str(tmp_path / "x.json")]
                    if driver is run_full else [])
    assert not (tmp_path / "x.json").exists()

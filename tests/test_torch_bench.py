"""The port's bench driver (cmvs_pmvs_tpu_torch/scripts/bench.py) on the
CPU, against the repository's root bench.py on the same inputs, and
run_full's warm engine on the cold engine's graph cache.

Sizes are small: the chained refinements at 64 patches of a 160x120
plane scene, 2 waves of 2 iterations, against a `jax.jit` of a
`lax.scan` of the JAX refine_patches built as bench.py builds it; the
scene stage on a 5-camera 96x72 occluded tree (expand_iters 1,
max_waves 2) against root bench._bench_scene, run once through the
port's `main` (its e2e stage) beside every other stage cut to its
smallest size. Tolerances as stated per test.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cmvs_pmvs_tpu.ops.refine as JR  # noqa: E402
from cmvs_pmvs_tpu.geom import build_camera_set as jax_cameras  # noqa: E402
from cmvs_pmvs_tpu.image import build_pyramids as jax_pyramids  # noqa

import cmvs_pmvs_tpu_torch.models.engine as engine  # noqa: E402
from cmvs_pmvs_tpu_torch.models.graphs import RefineGraphs  # noqa: E402
from cmvs_pmvs_tpu_torch.models.patches import empty_cloud  # noqa: E402
from cmvs_pmvs_tpu_torch.scripts import (  # noqa: E402
    bench, profile_e2e, profile_wave, run_full)
from cmvs_pmvs_tpu_torch.utils.trace import Tracer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the scene of the comparison with root bench._bench_scene (the JAX
# engine compiles for its shapes: this is most of the file's time)
SCENE = profile_e2e.Setup(5, 96, 72, 150.0, 0, 0.0, 1, 2, 8, 2000)
# the full stage cut to its smallest: one wave of one iteration
SMALLEST = dataclasses.replace(SCENE, max_waves=1, refine_iters=1)
# what the bench must leave alone: the JAX side's records
JAX_RECORDS = ("BENCH_PARTIAL.json", "bench_errors.log", "BENCH_FULL.json",
               os.path.join("docs", "scaling_latest.json"))


def jax_bench():
    """The root bench.py, loaded from its file (it runs nothing at
    import)."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def wave():
    return profile_wave.make_wave(64, width=160, height=120, focal=200.0,
                                  device="cpu")


def test_chain_matches_jax_scan(wave):
    """bench.chain (the CPU's central-difference LM) against bench.py's
    jitted scan of the JAX refine_patches on its CPU path, 2 chained
    waves of 2 iterations from the same start: >= 95% of patches within
    1e-2 dscale, and of a unit normal, of each other."""
    w = wave
    b, t = w.coord0.shape[0], w.cams.P.shape[0]
    coord0, normal = w.coord0.numpy(), w.normal.numpy()
    dscale = w.dscale.numpy()
    tc, tn, tnccs = bench.chain(w.cams, w.pyr, w.prob, w.coord0, w.normal,
                                nwave=2, num_iters=2)
    jc = jax_cameras(w.scene.P, dtype=jnp.float32)
    jp = jax_pyramids(list(w.scene.images), None, num_levels=3)
    views = np.tile(np.arange(t, dtype=np.int32)[None], (b, 1))
    jprob = JR.make_problem(jc, 0, jnp.asarray(coord0), jnp.asarray(normal),
                            jnp.asarray(views), jnp.ones((b, t), bool),
                            jnp.asarray(dscale), 3)

    @jax.jit
    def waves(coord, normal):
        def body(carry, _):
            c, n = carry
            c2, n2, ncc = JR.refine_patches(jc, jp, 0, 7, jprob, c, n,
                                            num_iters=2, with_ncc=True)[:3]
            return (c2, n2), ncc
        (c, n), nccs = jax.lax.scan(body, (coord, normal), None, length=2)
        return c, n, nccs

    JR.USE_PALLAS_INCC = False
    try:
        jcoord, jnormal, jnccs = waves(jnp.asarray(coord0),
                                       jnp.asarray(normal))
    finally:
        JR.USE_PALLAS_INCC = None
    assert tnccs.shape == jnccs.shape == (2, b)
    dc = np.linalg.norm(tc.numpy()[:, :3] - np.asarray(jcoord)[:, :3],
                        axis=1) / dscale
    dn = np.linalg.norm(tn.numpy()[:, :3] - np.asarray(jnormal)[:, :3],
                        axis=1)
    assert (dc <= 1e-2).mean() >= 0.95, np.sort(dc)[-5:]
    assert (dn <= 1e-2).mean() >= 0.95, np.sort(dn)[-5:]
    moved = np.linalg.norm(tc.numpy()[:, :3] - coord0[:, :3], axis=1)
    assert (moved > 0).mean() > 0.25


def test_chain_wave_two_starts_from_wave_one(wave):
    """The second wave refines the first wave's output, not the start:
    two chained waves equal one wave run on one wave's result, bit for
    bit, and differ from two waves from the start."""
    w = wave
    args = (w.cams, w.pyr, w.prob)
    c2, n2, nccs = bench.chain(*args, w.coord0, w.normal, nwave=2,
                               num_iters=2)
    c1, n1, ncc1 = bench.chain(*args, w.coord0, w.normal, nwave=1,
                               num_iters=2)
    c12, n12, ncc12 = bench.chain(*args, c1, n1, nwave=1, num_iters=2)
    assert torch.equal(c12, c2) and torch.equal(n12, n2)
    assert torch.equal(nccs[0], ncc1[0]) and torch.equal(nccs[1], ncc12[0])
    assert not torch.equal(c1, c2)


def test_bench_kernel_on_the_cpu(wave):
    """On the CPU the op-by-op chain is the headline; no graph, no
    kernel launches."""
    r = bench.bench_kernel(nwave=2, num_iters=2, device="cpu", wave=wave,
                           repeats=1)
    assert r["batch"] == 64 and r["k1_expected"] == 2 * 3
    assert r["refinements_per_sec"] == r["eager_refinements_per_sec"] > 0
    assert r["graph"] is None and r["graphed_refinements_per_sec"] is None
    assert r["k1_launches_per_eager_chain"] == 0


def stat(path):
    return os.stat(path).st_mtime_ns if os.path.exists(path) else None


@pytest.fixture(scope="module")
def jax_scene():
    """Root bench._bench_scene on SCENE's tree (the same scene, option
    text, run arguments and capacity), started in a thread of its own so
    that it runs beside the port's main (`main_run`); a future of its
    stats."""
    opt = (f"level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
           f"CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
           f"timages -1 0 {SCENE.num_cameras}\noimages 0\n")
    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(
            jax_bench()._bench_scene, "e2e", SCENE.num_cameras, SCENE.width,
            SCENE.height, SCENE.focal, opt, SCENE.run_kwargs(), 1e9,
            p_cap=SCENE.p_cap)


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    """The port's main on the CPU with every stage at its smallest (the
    e2e stage on SCENE, the full stage on SMALLEST, the kernel stage at
    64 patches of the 160x120 plane, 2 waves of 1 iteration, the baseline
    run for 0.5 s, the scaling curve at 1 rank of 16 patches): the lines
    printed, its build directory, the directory its scene trees were made
    in, and the JAX side's records before and after."""
    tmp = tmp_path_factory.mktemp("bench")
    (tmp / "tmp").mkdir()
    build = tmp / "build"
    before = {n: stat(os.path.join(ROOT, n)) for n in JAX_RECORDS}
    printed = io.StringIO()
    make_wave = profile_wave.make_wave

    def small_wave(batch, device):
        return make_wave(batch, width=160, height=120, focal=200.0,
                         device=device)

    def mkdtemp(**kwargs):
        return tempfile.mkdtemp(dir=tmp / "tmp", **kwargs)

    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(printed):
        mp.setattr(bench, "E2E", SCENE)
        mp.setattr(bench, "FULL", SMALLEST)
        mp.setattr(bench, "BASELINE_SECONDS", 0.5)
        mp.setattr(bench, "BATCH", 64)
        mp.setattr(bench, "NWAVE", 2)
        mp.setattr(bench, "NUM_ITERS", 1)
        mp.setattr(bench, "SCALING_BATCH", 16)
        mp.setattr(profile_wave, "make_wave", small_wave)
        # the port's own temp directories only: root bench.py's run in
        # its thread makes its own
        mp.setattr(run_full, "tempfile",
                   types.SimpleNamespace(mkdtemp=mkdtemp))
        for k in ("BENCH_SKIP_E2E", "BENCH_SKIP_FULL", "BENCH_SKIP_SCALING"):
            mp.delenv(k, raising=False)
        rc = bench.main(["--device", "cpu", "--build-dir", str(build),
                         "--scaling-ranks", "1"])
    return dict(rc=rc, lines=[json.loads(x) for x in
                              printed.getvalue().strip().splitlines()],
                build=build, tmp=tmp / "tmp", before=before,
                after={n: stat(os.path.join(ROOT, n)) for n in JAX_RECORDS})


def test_bench_scene_matches_jax(jax_scene, main_run):
    """The e2e stage against root bench._bench_scene on the same tree:
    bench.py's keys present in both, both steady, the patch counts within
    10%; the port's steady engine on the cold engine's graph cache (none
    on the CPU), its cloud within the occluded tests' median bar."""
    ours, theirs = main_run["lines"][1]["extra"], jax_scene.result()
    keys = {f"e2e_{k}" for k in ("patches", "seconds", "patches_per_sec",
                                 "steady", "phase_seconds")}
    assert keys <= set(theirs) and keys <= set(ours)
    assert ours["e2e_steady"] and theirs["e2e_steady"]
    nj, n = theirs["e2e_patches"], ours["e2e_patches"]
    assert nj > 50 and abs(n - nj) <= 0.1 * nj, (n, nj)
    assert set(ours["e2e_phase_seconds"]) == {"detect", "seed", "refresh",
                                              "expand", "filter"}
    assert ours["e2e_cold_graphs"] is None and ours["e2e_graphs"] is None
    assert ours["e2e_launches"] == {}
    assert ours["e2e_median"] < 0.4
    assert ours["e2e_patches_per_sec"] == n / ours["e2e_seconds"]


@pytest.mark.parametrize("flag", ["--batch", "--nwave", "--iters",
                                  "--scaling-batch"])
def test_main_takes_no_size_flags(flag, tmp_path):
    """The headline's sizes are bench.py's constants: main has no flag
    that would print the metric at another batch or chain length."""
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()):
        bench.main(["--device", "cpu", "--build-dir", str(tmp_path / "b"),
                    flag, "16"])
    assert not (tmp_path / "b").exists()


def test_bench_scene_reports_the_cold_run_past_its_budget():
    """bench.py's budget rule: a cold run longer than the budget is
    reported alone, as not steady."""
    r = bench._bench_scene("t", SMALLEST, 0.0, "cpu")
    assert r["t_steady"] is False
    assert r["t_seconds"] == r["t_cold_seconds"] > 0
    assert r["t_patches"] == r["t_cold_patches"]
    assert "t_patches_per_sec" not in r and "t_graphs" not in r


def test_main_prints_the_headline_then_a_line_per_stage(main_run):
    """The headline first, then the line again after the e2e, the full
    and the scaling stage, `extra` growing; every line names the card;
    no stage failed."""
    lines = main_run["lines"]
    assert main_run["rc"] == 0 and len(lines) == 4
    head = lines[0]
    assert head["metric"] == "patch_refinements_per_sec_per_chip"
    assert "extra" not in head and head["card"] == "cpu"
    assert head["value"] == head["kernel"]["eager_refinements_per_sec"]
    assert head["vs_baseline"] == pytest.approx(
        head["value"] / head["baseline_patches_per_sec_16core"])
    assert head["vs_baseline_equal_work"] == pytest.approx(
        head["value"] * 24 / (193092.0 * 16))
    k = head["kernel"]
    # the module's constants, read when the stage runs
    assert (k["batch"], k["nwave"], k["num_iters"]) == (64, 2, 1)
    assert k["k1_expected"] == 2 * 2
    for ln in lines[1:]:
        assert {k: v for k, v in ln.items() if k != "extra"} == head
    grown = [set(ln["extra"]) for ln in lines[1:]]
    assert grown[0] < grown[1] < grown[2]
    assert all(k.startswith("e2e_") for k in grown[0])
    assert all(k.startswith("full_") for k in grown[1] - grown[0])
    assert grown[2] - grown[1] == {"scaling"}
    extra = lines[-1]["extra"]
    assert not [k for k in extra if k.endswith("_error")], extra
    assert set(extra["full_bars"]) == {"patches", "median", "q90", "ok"}
    assert not extra["full_bars"]["patches"]       # far below 80,000
    assert list(extra["scaling"]["refines_per_sec_by_ranks"]) == ["1"]


def test_main_writes_only_under_its_build_dir(main_run):
    """The partial line, the curve and the baseline's executable in the
    build directory; the scene trees removed; the JAX side's records at
    the repository's root untouched."""
    build = main_run["build"]
    # the microbench, or the log of why it could not be built
    built = "cpu_baseline" if shutil.which("g++") else "bench_errors.log"
    assert sorted(os.listdir(build)) == sorted(
        ["bench_partial.json", built, "scaling_latest.json"])
    with open(build / "bench_partial.json") as f:
        assert json.load(f) == main_run["lines"][-1]
    with open(build / "scaling_latest.json") as f:
        curve = json.load(f)
    assert curve["refines_per_sec_by_ranks"] == \
        main_run["lines"][-1]["extra"]["scaling"]["refines_per_sec_by_ranks"]
    assert os.listdir(main_run["tmp"]) == []
    assert main_run["after"] == main_run["before"]


def test_measure_baseline_floors_at_the_recorded_constant(tmp_path,
                                                          monkeypatch):
    """A fast host's measurement is the divisor, a slow host's is floored
    at the recorded constant, and without the microbench the constant is
    used; `baseline_source` says which."""
    exe = tmp_path / "cpu_baseline"

    def fake(eps):
        exe.write_text(f"#!/bin/sh\necho '{{\"evals_per_sec\": {eps}}}'\n")
        exe.chmod(0o755)
        os.utime(exe, (4e9, 4e9))      # newer than the source
    fake(400000.0)
    r = bench.measure_baseline(tmp_path)
    assert r["baseline_patches_per_sec_16core"] == 400000.0 * 16 / 100
    assert r["baseline_source"].startswith("measured on this host")
    fake(1000.0)
    r = bench.measure_baseline(tmp_path)
    assert r["baseline_patches_per_sec_16core"] == 30895.0
    assert r["baseline_source"].startswith("recorded constant")
    assert "16-core Xeon estimate" in r["baseline_source"]
    assert r["baseline_host_evals_per_sec"] == 1000.0
    exe.unlink()
    monkeypatch.setattr(bench.shutil, "which", lambda name: None)
    r = bench.measure_baseline(tmp_path)
    assert r["baseline_patches_per_sec_16core"] == 30895.0
    assert r["baseline_source"].startswith("recorded constant")
    assert "g++" in r["baseline_source"]
    assert r["baseline_host_evals_per_sec"] is None
    assert (tmp_path / "bench_errors.log").exists()


def test_short_error_is_compact():
    err = RuntimeError("\x1b[31mred\x1b[0m\n" + "x" * 500)
    msg = bench.short_error(err, "stage", "/nonexistent/dir")
    assert msg.startswith("RuntimeError: red ") and len(msg) == 200
    assert msg.isprintable()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_bench_needs_cuda_by_default(no_cuda, tmp_path, wave):
    """main, the kernel stage and the scene stage run on CUDA unless told
    otherwise, and raise without it before writing anything."""
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--build-dir", str(tmp_path / "b")])
    assert not (tmp_path / "b").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.bench_kernel(wave=wave)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.bench_e2e()


class StubGraphs:
    """A graph cache that holds 3 graphs and never captures more."""

    def stats(self):
        return {"graphs": 3, "capture_seconds": 1.5, "replays": 0}

    stats_since = RefineGraphs.stats_since


class FakeEngine:
    """An engine that records the graphs it is given and runs nothing;
    given none, it makes a cache as the engine does on a card."""

    made: list = []

    def __init__(self, scene, opt, p_cap, log, device, graphs=None):
        FakeEngine.made.append(graphs)
        self.graphs = graphs if graphs is not None else StubGraphs()
        self.cloud = empty_cloud(8, 4)
        self.tracer = Tracer()

    def run(self, **kwargs):
        pass


def test_run_full_warm_engine_takes_the_cold_engines_graphs(monkeypatch):
    """run_full builds its warm engine with the cold engine's graph cache
    (on a card the cold engine's own RefineGraphs), and reports each
    run's captures: the warm run's are 0."""
    FakeEngine.made = []
    monkeypatch.setattr(engine, "PMVSEngine", FakeEngine)
    r = run_full.run(SMALLEST, device="cpu", log=lambda *a: None)
    cold, warm = FakeEngine.made
    assert cold is None and isinstance(warm, StubGraphs)
    assert r["cold_graphs"]["captured"] == 3
    assert r["graphs"]["captured"] == 0 and r["graphs"]["graphs"] == 3

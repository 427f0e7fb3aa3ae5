"""Fault injection and recovery in the port (tests/test_fault.py's two
recovery seams, and the port's own multi-rank launch).

  * cluster level: a pmvs3_all-style worker process
    (tests/_torch_fault_worker.py) is SIGKILLed while its second cluster
    reconstructs; the files a kill during the write would leave are
    truncated; a rerun skips the finished cluster (its files untouched),
    overwrites the interrupted one, and every file equals a clean
    uninterrupted run of the port on an identical tree, byte for byte;
  * engine level under a mesh: a one-rank checkpoint taken after
    iteration 1, resumed by the data-parallel engine on 2 gloo ranks,
    gives the one-rank resume's cloud and grid bit for bit, also at a
    capacity that 2 ranks do not divide (the one-rank resume itself is
    held to the uninterrupted run by test_torch_resume.py);
  * slow tier, as test_fault.py is: torchrun's rank 1 SIGKILLed while
    rank 0 waits at the merge barrier: the job ends non-zero within 60
    s and writes no merge, and a rerun's merge equals the clean run's;
    and the resumed merge held to the JAX package's clean run_clusters
    on the same tree (counts within 10%, both medians of plane distance
    / dscale < 0.3 and within 0.05 of each other).

Every subprocess wait has a timeout of 120 s or less.
"""
import glob
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu_torch.io.patches import read_patch_file  # noqa: E402
from cmvs_pmvs_tpu_torch.models.engine import (  # noqa: E402
    PMVSEngine, load_scene)
from cmvs_pmvs_tpu_torch.parallel import workers  # noqa: E402
from cmvs_pmvs_tpu_torch.parallel.clusters import (  # noqa: E402
    merge_models, run_clusters)
from cmvs_pmvs_tpu_torch.parallel.launch import RankPool  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_fault_worker.py")
# the worker's size (tests/test_fault.py's)
SIZE = dict(p_cap=8192, expand_iters=1, max_waves=1, refine_iters=4)
EXTS = (".patch", ".ply", ".pset")
QUIET = dict(log=lambda *a: None)
WAIT = 120


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return env


def _make_cluster_tree(root: str):
    """test_fault.py's tree (6 plane cameras, two overlapping clusters,
    pmvs.sh) at 96x72."""
    scene = make_plane_scene(num_cameras=6, width=96, height=72,
                             focal=135.0)
    write_pmvs_tree(scene, root)
    for i, tail in enumerate(["timages 3 0 1 2\noimages 1 3\n",
                              "timages 3 3 4 5\noimages 1 2\n"]):
        with open(os.path.join(root, f"option-{i:04d}"), "w") as f:
            f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\n"
                    "minImageNum 3\nCPU 4\nsetEdge 0\nuseBound 0\n"
                    "useVisData 0\nsequence -1\n" + tail)
    with open(os.path.join(root, "pmvs.sh"), "w") as f:
        f.write("pmvs2 ./ option-0000\npmvs2 ./ option-0001\n")
    return scene


def _files(root: str, name: str) -> dict:
    return {ext: open(os.path.join(root, "models", name + ext), "rb").read()
            for ext in EXTS}


def _wait_for(path: str, proc, log_path: str):
    deadline = time.monotonic() + WAIT
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise AssertionError(f"the worker exited ({proc.returncode}) "
                                 f"before {path}:\n"
                                 + open(log_path).read()[-3000:])
        if time.monotonic() > deadline:
            proc.kill()
            proc.wait(timeout=WAIT)
            raise AssertionError(f"no {path} within {WAIT} s")
        time.sleep(0.02)


def _worker(root: str, log_path: str) -> subprocess.Popen:
    with open(log_path, "w") as out:
        return subprocess.Popen([sys.executable, WORKER, "clusters", root,
                                 "cpu"], env=_env(), cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT)


def _kill_and_resume(shared: str, logs: str) -> dict:
    """Run the worker over `shared`, SIGKILL it once it has started
    option-0001, truncate option-0001's files, rerun it. Returns the
    rerun's output and option-0000's files as the killed run left
    them."""
    models = os.path.join(shared, "models")
    log_path = os.path.join(logs, "killed.log")
    proc = _worker(shared, log_path)
    _wait_for(os.path.join(shared, "started-option-0001"), proc, log_path)
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=WAIT)
    assert proc.returncode == -signal.SIGKILL, open(log_path).read()
    # the kill landed while cluster 1 reconstructed: cluster 0 finished,
    # cluster 1 started and never finished
    assert os.path.exists(os.path.join(models, "option-0000.done"))
    assert not os.path.exists(os.path.join(models, "option-0001.done"))
    killed0 = _files(shared, "option-0000")
    # what a kill during cluster 1's write would leave
    for ext, head in zip(EXTS, ("PATCHES\n1", "ply\nformat ascii 1.0\nel",
                                "3\n0.1 0.2")):
        with open(os.path.join(models, "option-0001" + ext), "w") as f:
            f.write(head)
    rerun = subprocess.run([sys.executable, WORKER, "clusters", shared,
                            "cpu"], env=_env(), cwd=ROOT,
                           capture_output=True, text=True, timeout=WAIT)
    assert rerun.returncode == 0, rerun.stdout[-3000:] + rerun.stderr[-3000:]
    return {"stdout": rerun.stdout, "killed0": killed0}


def test_cluster_worker_sigkill_then_resume(tmp_path):
    shared, solo = str(tmp_path / "shared"), str(tmp_path / "solo")
    _make_cluster_tree(shared)
    shutil.copytree(shared, solo)
    # a clean uninterrupted run of the port on an identical tree, in a
    # worker of its own beside the killed one
    clean = _worker(solo, str(tmp_path / "clean.log"))
    try:
        r = _kill_and_resume(shared, str(tmp_path))
    finally:
        clean.wait(timeout=WAIT)
    assert clean.returncode == 0, open(tmp_path / "clean.log").read()
    assert "[option-0000] already complete, skipping" in r["stdout"]
    assert "[option-0001] reconstructing on process 0/1" in r["stdout"]
    assert "[option-0000] reconstructing" not in r["stdout"]
    assert os.path.exists(os.path.join(shared, "models",
                                       "option-0001.done"))
    # the finished cluster's files are as the killed run wrote them
    assert _files(shared, "option-0000") == r["killed0"]
    for name in ("option-0000", "option-0001"):
        assert _files(shared, name) == _files(solo, name), name
    merge_models(shared)
    merge_models(solo)
    assert _files(shared, "all") == _files(solo, "all")
    assert len(read_patch_file(os.path.join(solo, "models",
                                            "all.patch"))) > 0


def _resume_tree(root: str):
    sc = make_plane_scene(num_cameras=5, width=96, height=72, focal=140.0)
    write_pmvs_tree(sc, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                "timages -1 0 5\noimages 0\n")


@pytest.mark.parametrize("p_cap", [8192, 2047])
def test_mesh_engine_resumes_one_rank_checkpoint(tmp_path, p_cap):
    """test_torch_resume's checkpoint (one rank, after iteration 1)
    resumed under a 2-rank engine mesh: every rank's cloud and grid equal
    the one-rank resume's, bit for bit, the capacity included; 2047 is a
    loaded capacity that the mesh's ranks do not divide."""
    root = str(tmp_path / "scene")
    _resume_tree(root)
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt, device="cpu")
    kw = dict(max_waves=2, refine_iters=4)

    def engine():
        return PMVSEngine(data, opt, p_cap=p_cap, device="cpu", **QUIET)
    with RankPool(2, "cpu", str(tmp_path)) as pool:
        # the ranks start while the checkpoint is made
        eng = engine()
        eng.run(expand_iters=1, **kw)
        assert eng.p_cap == p_cap
        ckpt = os.path.join(root, "state.npz")
        eng.save_checkpoint(ckpt, iteration=1)
        pool.start(workers.resume_job, 2, root, "option.txt", ckpt, p_cap,
                   dict(expand_iters=2, **kw))
        one = engine()
        assert one.load_checkpoint(ckpt) == 1
        one.run(expand_iters=2, start_iter=1, **kw)
        outs = pool.wait()
    want = workers.state_digests(one)
    assert int(one.cloud.count()) > 0
    for r, o in enumerate(outs):
        assert o["iteration"] == 1 and o["p_cap"] == one.p_cap
        assert o["state"].keys() == want.keys()
        differ = [k for k in want if o["state"][k] != want[k]]
        assert not differ, (r, differ)
        assert o["stats"] == one.stats


def _children(pid: int) -> list:
    """The pids of `pid`'s children (/proc/<pid>/task/*/children)."""
    out = []
    for path in glob.glob(f"/proc/{pid}/task/*/children"):
        with open(path) as f:
            out += [int(c) for c in f.read().split()]
    return out


def _stop(proc):
    """SIGKILL `proc` and its children, if it still runs (torchrun starts
    its ranks in sessions of their own), and reap it."""
    if proc.poll() is None:
        for pid in _children(proc.pid) + [proc.pid]:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    proc.wait(timeout=WAIT)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


@pytest.mark.slow
def test_torchrun_rank_killed_then_rerun(tmp_path):
    """pmvs3_all under torchrun on 2 gloo ranks (--device cpu): rank 0's
    cluster is already done (the clean run's files and .done marker), so
    rank 0 waits at the merge barrier while rank 1 reconstructs; rank 1
    is SIGKILLed there. The job ends non-zero within 60 s, no rank is
    left in the barrier and nothing is merged; a rerun exits 0 and its
    merge equals the clean run's, byte for byte."""
    shared, solo = str(tmp_path / "shared"), str(tmp_path / "solo")
    _make_cluster_tree(shared)
    shutil.copytree(shared, solo)
    clean = _worker(solo, str(tmp_path / "clean.log"))
    clean.wait(timeout=WAIT)
    assert clean.returncode == 0, open(tmp_path / "clean.log").read()
    merge_models(solo)
    models = os.path.join(shared, "models")
    os.makedirs(models, exist_ok=True)
    for ext in EXTS + (".done",):
        shutil.copy(os.path.join(solo, "models", "option-0000" + ext),
                    models)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", WORKER, "cli", shared, "--device", "cpu"]
    log_path = str(tmp_path / "killed.log")
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, env=_env(), cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT)
    try:
        started = os.path.join(shared, "started-option-0001")
        _wait_for(started, proc, log_path)
        rank1 = int(open(started).read())
        ranks = _children(proc.pid)
        assert rank1 in ranks and len(ranks) == 2, (rank1, ranks)
        os.kill(rank1, signal.SIGKILL)
        t0 = time.monotonic()
        proc.wait(timeout=60)
        seconds = time.monotonic() - t0
        log = open(log_path).read()
        assert proc.returncode != 0, log[-3000:]
        assert seconds < 60
        assert not any(_alive(p) for p in ranks), log[-3000:]
        assert "1 clusters, 0 patches" in log    # rank 0 reached the barrier
        assert not glob.glob(os.path.join(models, "all.*"))
        assert not os.path.exists(os.path.join(models, "option-0001.done"))
    finally:
        _stop(proc)
    log_path = str(tmp_path / "rerun.log")
    with open(log_path, "w") as out:
        rerun = subprocess.Popen(cmd, env=_env(), cwd=ROOT, stdout=out,
                                 stderr=subprocess.STDOUT)
    try:
        rc = rerun.wait(timeout=WAIT)
    finally:
        _stop(rerun)
    log = open(log_path).read()
    assert rc == 0, log[-3000:]
    assert "merged" in log
    assert _files(shared, "all") == _files(solo, "all")


@pytest.mark.slow
def test_resumed_merge_matches_jax_clean_run(tmp_path):
    """The killed-and-resumed port run's merge against the JAX package's
    clean run_clusters on an identical tree, with test_torch_resume's
    bars."""
    from cmvs_pmvs_tpu.io.patches import read_patch_file as jax_read
    from cmvs_pmvs_tpu.parallel.clusters import merge_models as jax_merge
    from cmvs_pmvs_tpu.parallel.clusters import run_clusters as jax_run
    shared, ref = str(tmp_path / "shared"), str(tmp_path / "jax")
    scene = _make_cluster_tree(shared)
    shutil.copytree(shared, ref)
    _kill_and_resume(shared, str(tmp_path))
    got = read_patch_file(merge_models(shared) + ".patch")
    jax_run(ref, process_index=0, process_count=1, **SIZE, **QUIET)
    want = jax_read(jax_merge(ref) + ".patch")
    assert len(want) > 0
    assert abs(len(got) - len(want)) <= 0.1 * len(want), (len(got),
                                                          len(want))

    def median(recs):
        coord = np.array([r.coord[:3] for r in recs])
        return float(np.median(scene.plane_distance(coord)
                               / np.array([r.dscale for r in recs])))
    m_port, m_jax = median(got), median(want)
    assert m_port < 0.3 and m_jax < 0.3, (m_port, m_jax)
    assert abs(m_port - m_jax) < 0.05, (m_port, m_jax)

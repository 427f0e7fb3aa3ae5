"""The port's multi-rank engine and cluster CLI on gloo ranks on the CPU.

Counterpart of test_multiprocess.py and of test_parallel.py's
test_sharded_engine_matches_local:

  * the data-parallel engine (`PMVSEngine(mesh=make_engine_mesh())`,
    parallel/engine_shard.py) on 2 spawned ranks, on that test's scene
    and run, against the JAX engine single-device and on the 8-device
    mesh (count within max(2, n // 20), median plane distance / dscale
    < 0.3, its bars) and against the port's single-rank engine (count
    within max(2, n // 100); on the CPU the clouds are also bit-equal);
    the ranks' final clouds byte-identical;
  * pmvs3_all under env-style init (RANK / WORLD_SIZE / LOCAL_RANK, as
    torchrun sets them): two CLI processes split the clusters and rank
    0 merges only after the barrier, and the merge equals a
    single-process run (test_two_process_clusters_match_single);
  * the four-rank engine, in the slow tier as test_multiprocess.py is.
"""
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu.models.engine import PMVSEngine as JaxEngine  # noqa: E402
from cmvs_pmvs_tpu.models.engine import load_scene as jax_load  # noqa: E402
from cmvs_pmvs_tpu.parallel.engine_shard import (  # noqa: E402
    make_engine_mesh as jax_engine_mesh)
from cmvs_pmvs_tpu.utils.options import PMVSOptions as JaxOptions  # noqa

from cmvs_pmvs_tpu_torch.io.patches import read_patch_file  # noqa: E402
from cmvs_pmvs_tpu_torch.models.engine import reconstruct  # noqa: E402
from cmvs_pmvs_tpu_torch.parallel import comm, workers  # noqa: E402
from cmvs_pmvs_tpu_torch.parallel.clusters import (  # noqa: E402
    merge_models, run_clusters)
from cmvs_pmvs_tpu_torch.parallel.launch import RankPool  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTION = ("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\nCPU 4\n"
          "setEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
          "timages -1 0 4\noimages 0\n")
RUN = dict(expand_iters=1, max_waves=1, refine_iters=4)
QUIET = dict(log=lambda *a: None)


@pytest.fixture(scope="module")
def engine_scene(tmp_path_factory):
    """test_sharded_engine_matches_local's scene and the JAX engine's
    clouds on it, single-device and on the 8-device mesh."""
    root = str(tmp_path_factory.mktemp("dp"))
    sc = make_plane_scene(num_cameras=4, width=96, height=72, focal=160.0)
    write_pmvs_tree(sc, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write(OPTION)
    opt = JaxOptions.parse(os.path.join(root, "option.txt"))
    data = jax_load(root, opt)
    jax_clouds = {}
    for name, mesh in (("single", None), ("mesh", jax_engine_mesh(8))):
        eng = JaxEngine(data, opt, p_cap=2048, mesh=mesh, **QUIET)
        eng.run(**RUN)
        alive = np.asarray(eng.cloud.alive)
        jax_clouds[name] = (np.asarray(eng.cloud.coord)[alive],
                            np.asarray(eng.cloud.dscale)[alive])
    return sc, root, jax_clouds


@pytest.fixture(scope="module")
def port_ranks(engine_scene, tmp_path_factory):
    _, root, _ = engine_scene
    with RankPool(2, "cpu", str(tmp_path_factory.mktemp("store"))) as pool:
        return pool.run(workers.engine_job, 2, root, "option.txt", 2048, RUN)


def _median(sc, coord, dscale):
    return float(np.median(sc.plane_distance(coord[:, :3]) / dscale))


def test_data_parallel_engine_matches_jax(engine_scene, port_ranks):
    sc, _, jax_clouds = engine_scene
    out = port_ranks[0]
    n = out["count"]
    assert n > 50
    assert _median(sc, out["coord"], out["dscale"]) < 0.3
    for name, (coord, dscale) in jax_clouds.items():
        n_j = len(coord)
        assert abs(n - n_j) <= max(2, n_j // 20), (name, n, n_j)
        assert _median(sc, coord, dscale) < 0.3, name
    assert out["backend"] == "gloo"


def test_data_parallel_engine_matches_single_rank(engine_scene, port_ranks):
    _, root, _ = engine_scene
    eng = reconstruct(root, "option.txt", p_cap=2048, device="cpu", **QUIET,
                      **RUN)
    n_1 = int(eng.cloud.count())
    assert abs(port_ranks[0]["count"] - n_1) <= max(2, n_1 // 100)
    # on the CPU every candidate row's result is independent of the
    # batch it was refined in: the two-rank cloud is the one-rank cloud
    assert port_ranks[0]["digest"] == workers.cloud_digest(eng.cloud)


def test_ranks_end_with_byte_identical_clouds(port_ranks):
    assert port_ranks[0]["digest"] == port_ranks[1]["digest"]
    assert port_ranks[0]["p_cap"] == port_ranks[1]["p_cap"]
    assert port_ranks[0]["stats"] == port_ranks[1]["stats"]


def test_rank_device_and_backend(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert comm.rank_device("cuda", 3) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert comm.rank_device() == torch.device("cuda", 0)
    assert comm.rank_device("cuda:1", 0) == torch.device("cuda", 1)
    assert comm.rank_device("cpu", 5) == torch.device("cpu")
    assert comm.choose_backend(torch.device("cuda", 0), 2) == "nccl"
    assert comm.choose_backend(torch.device("cuda", 0), 3) == "gloo"
    assert comm.choose_backend(torch.device("cpu"), 1) == "gloo"


# The CLI ranks run pmvs3_all's main() as it is, with reconstruct's run
# cut to test_multiprocess.py's size (one expand round of one wave).
_CLI = """
import sys
import torch
torch.set_num_threads(1)
import cmvs_pmvs_tpu_torch.models.engine as engine
full = engine.reconstruct
def small(prefix, name, **kw):
    kw.update(p_cap=8192, expand_iters=1, max_waves=1, refine_iters=4)
    return full(prefix, name, **kw)
engine.reconstruct = small
from cmvs_pmvs_tpu_torch.cli import pmvs_all
sys.exit(pmvs_all.main(sys.argv[1:]))
"""


def _cluster_tree(root: str):
    """test_multiprocess.py's tree: two overlapping clusters."""
    scene = make_plane_scene(num_cameras=6, width=128, height=96,
                             focal=180.0)
    write_pmvs_tree(scene, root)
    for i, tail in enumerate(["timages 3 0 1 2\noimages 1 3\n",
                              "timages 3 3 4 5\noimages 1 2\n"]):
        with open(os.path.join(root, f"option-{i:04d}"), "w") as f:
            f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\n"
                    "minImageNum 3\nCPU 4\nsetEdge 0\nuseBound 0\n"
                    "useVisData 0\nsequence -1\n" + tail)
    with open(os.path.join(root, "pmvs.sh"), "w") as f:
        f.write("pmvs2 ./ option-0000\npmvs2 ./ option-0001\n")


def test_cli_ranks_split_clusters_and_merge_after_barrier(tmp_path):
    """Rank 0's cluster is already done (its files and .done marker
    copied from the single-process run), so rank 0 reaches the merge at
    once while rank 1 still reconstructs: only the barrier makes its
    merge hold both clusters."""
    shared, solo = str(tmp_path / "shared"), str(tmp_path / "solo")
    _cluster_tree(shared)
    shutil.copytree(shared, solo)
    run_clusters(solo, process_index=0, process_count=1, p_cap=8192,
                 checkpoint=True, device="cpu", expand_iters=1, max_waves=1,
                 refine_iters=4, **QUIET)
    os.makedirs(os.path.join(shared, "models"), exist_ok=True)
    for ext in (".patch", ".ply", ".pset", ".done"):
        shutil.copy(os.path.join(solo, "models", "option-0000" + ext),
                    os.path.join(shared, "models"))

    with socket.socket() as s:      # a free port for the env:// store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CLI, shared, "--device", "cpu"],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
        outs.append(out)
    assert "1 clusters, 0 patches" in outs[0]        # its one was done
    assert "merged" in outs[0] and "merged" not in outs[1]
    assert os.path.exists(os.path.join(shared, "models",
                                       "option-0001.done"))

    merged = read_patch_file(merge_models(solo) + ".patch")
    got = read_patch_file(os.path.join(shared, "models", "all.patch"))
    assert len(got) > 0 and len(got) == len(merged)
    c_mp = np.sort(np.array([r.coord[:3] for r in got]), axis=0)
    c_sp = np.sort(np.array([r.coord[:3] for r in merged]), axis=0)
    np.testing.assert_allclose(c_mp, c_sp, atol=1e-4)


@pytest.mark.slow
def test_four_rank_engine(engine_scene, tmp_path):
    """Counterpart of test_four_process_gspmd_engine: four ranks, the
    same bar against the single-rank engine."""
    _, root, _ = engine_scene
    with RankPool(4, "cpu", str(tmp_path)) as pool:
        outs = pool.run(workers.engine_job, 4, root, "option.txt", 4096, RUN)
    eng = reconstruct(root, "option.txt", p_cap=4096, device="cpu", **QUIET,
                      **RUN)
    n_sp, n_mp = int(eng.cloud.count()), outs[0]["count"]
    assert n_mp > 0
    assert abs(n_mp - n_sp) <= max(3, int(0.05 * n_sp)), (n_mp, n_sp)
    assert len({o["digest"] for o in outs}) == 1

"""A cell on several cards through the same window loop, on the CPU: a
tiny mesh cell of two gloo ranks (the harness rank 0, one spawned rank)
comes out correct, its window ends on whole A/B pairs, and it reads the
mesh's per-layer metrics; the row all-gather's exchange left out turns
it not correct; a rank that dies or hangs ends the run with a failed
job and a result line.

Each run drives `run.run_cell` (device="cpu") on a copy of the
benchmark with the cells `tiny.l0` and `tiny.mesh` added: the tiny
cell's scenes, `seconds` 0."""
import json
import os
import subprocess
import sys

import pytest

from mvsbench import faults, run

from conftest import REPO, TINY, add_tiny_cell

SEED = 2**31 + 77
MESH = "tiny.mesh"


def add_mesh_cell(root: str, ranks: int = 2):
    """`tiny.mesh`: the tiny cell's configuration on an engine mesh of
    `ranks` ranks, its traffic with `whole_pairs`, listed wherever the
    manifest lists ring.l0.mesh4."""
    add_tiny_cell(root)
    mv = os.path.join(root, "mvsbench")
    with open(os.path.join(mv, "traffic", "tiny.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(mv, "traffic", "tiny-mesh.json"), "w") as f:
        json.dump({**traffic, "whole_pairs": True}, f)
    with open(os.path.join(mv, "limits", TINY + ".json")) as f:
        limits = json.load(f)
    with open(os.path.join(mv, "limits", MESH + ".json"), "w") as f:
        json.dump(limits, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": MESH, "config": "tiny",
                               "traffic": "tiny-mesh", "chips": ranks,
                               "why": "a test's"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ring.l0.mesh4" in m.get("workloads", ()):
            m["workloads"].append(MESH)
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def mesh_copy(bench_copy):
    add_mesh_cell(bench_copy)
    return bench_copy


def test_mesh_cell_is_correct_on_whole_pairs(mesh_copy):
    res = run.run_cell(mesh_copy, MESH, SEED, 0.0, True, device="cpu")
    assert res["correct"], json.dumps(res["compared"])
    # `seconds` 0: one job would do; whole pairs take two
    assert res["attempted"] == 2 and res["failed"] == 0
    assert res["device"]["count"] == 2
    m = res["metrics"]
    assert m["rank_wait_s"]["value"] >= 0
    for name in ("seed_s.mesh", "expand_s.mesh", "filter_s.mesh",
                 "engine_write_s.mesh", "untraced_s.mesh", "cold_recon_s"):
        assert m[name]["value"] > 0, name
    # neither the harness's wraps, the one-card kernel count, nor the
    # one-card names of the split metrics; no NCCL on the CPU
    for name in ("load_s", "write_s", "k1_roofline_pct", "seed_s",
                 "nccl_s"):
        assert name not in m


def test_mesh_cell_reports_mesh_recon_s(mesh_copy):
    """Untraced, the mesh cell reports its own end-to-end metric."""
    res = run.run_cell(mesh_copy, MESH, SEED, 0.0, False, device="cpu")
    assert res["correct"], json.dumps(res["compared"])
    assert list(res["metrics"]) == ["mesh_recon_s", "setup_s"]
    assert res["metrics"]["mesh_recon_s"]["value"] > 0


def test_exchange_left_out_is_not_correct(mesh_copy):
    res = run.run_cell(mesh_copy, MESH, SEED, 0.0, False, device="cpu",
                       faults=faults.own_rows)
    assert not res["correct"]
    assert res["failed"] >= 1


def test_dead_rank_ends_with_a_failed_job(mesh_copy):
    res = run.run_cell(mesh_copy, MESH, SEED, 0.0, False, device="cpu",
                       faults=faults.rank_dies)
    assert not res["correct"]
    assert res["attempted"] == res["failed"] == 1


def test_hung_rank_ends_with_a_result_line(mesh_copy):
    """Rank 0 waits in a collective for a rank that never comes: the
    watchdog ends the run at the job's deadline, with a result line."""
    script = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from mvsbench import faults, mesh, run\n"
        "mesh.SETUP_DEADLINE = 10.0\n"
        "run.run_cell(%r, %r, %d, 0.0, False, device='cpu',"
        " faults=faults.rank_hangs)\n"
        % (REPO, os.path.dirname(__file__), mesh_copy, MESH, SEED))
    out = subprocess.run([sys.executable, "-c", script], cwd=mesh_copy,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 1, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False and res["failed"] == 1
    assert res["device"]["count"] == 2
    assert "still in a job" in out.stderr

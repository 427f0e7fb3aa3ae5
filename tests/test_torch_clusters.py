"""The port's cluster scheduler (parallel/clusters.py) and its cmvs3,
genOption and pmvs3_all CLIs, on the CPU.

Ports of test_clusters.py's three tests; the merged files byte for byte
against the JAX package's merge of the same tree; the CLIs' argv and
their CUDA default; one small cmvs3 -> genOption -> pmvs3_all run over
two clusters of an occluded scene, held to the protocol's accuracy bars
(surface distance / dscale median < 0.4, q90 < 1.5).
"""
import filecmp
import os
import tomllib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu.io.patches import PatchRecord, write_patch_file  # noqa
from cmvs_pmvs_tpu.io.ply import write_patch_ply  # noqa: E402
from cmvs_pmvs_tpu.parallel.clusters import merge_models as jax_merge  # noqa

import cmvs_pmvs_tpu_torch.models.engine as engine  # noqa: E402
from cmvs_pmvs_tpu_torch.cli import cmvs as cli_cmvs  # noqa: E402
from cmvs_pmvs_tpu_torch.cli import genoption as cli_gen  # noqa: E402
from cmvs_pmvs_tpu_torch.cli import pmvs_all as cli_all  # noqa: E402
from cmvs_pmvs_tpu_torch.io.patches import read_patch_file, read_pset  # noqa
from cmvs_pmvs_tpu_torch.io.ply import read_ply_xyz  # noqa: E402
from cmvs_pmvs_tpu_torch.io.ske import read_ske  # noqa: E402
from cmvs_pmvs_tpu_torch.parallel import clusters  # noqa: E402
from cmvs_pmvs_tpu_torch.parallel.clusters import (  # noqa: E402
    assign_clusters, discover_options, merge_models, run_clusters)
from cmvs_pmvs_tpu_torch.utils.synthetic import (  # noqa: E402
    make_occluded_scene, write_bundle_file, write_pmvs_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda *a: None)


def _make_tree(root, n_clusters):
    """test_clusters.py's tree: pmvs.sh, option files and two patches per
    cluster written by the JAX package's writers."""
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    names = ["option-%04d" % c for c in range(n_clusters)]
    with open(os.path.join(root, "pmvs.sh"), "w") as f:
        f.write("".join(f"pmvs3 pmvs/ {n}\n" for n in names))
    rng = np.random.default_rng(n_clusters)
    for c, name in enumerate(names):
        with open(os.path.join(root, name), "w") as f:
            f.write("level 1\n")
        coords = np.array([[c, 0.0, 1.0], [c, 1.0, 2.0]])
        coords[:, 1:] += rng.normal(0, 1, (2, 2))     # 17 digits to keep
        normals = np.tile([0.0, 0.0, -1.0], (2, 1))
        recs = [PatchRecord(np.append(coords[i], 1.0),
                            np.append(normals[i], 0.0), ncc=0.8 - 0.1 * i,
                            dscale=0.01 * (c + 1), ascale=0.5,
                            images=[c, c + 1], vimages=[c + 2][:i])
                for i in range(2)]
        stem = os.path.join(root, "models", name)
        write_patch_file(stem + ".patch", recs)
        write_patch_ply(stem + ".ply", coords, normals,
                        quality=np.full(2, 0.8), force_python=True)
    return names


def _fake_engine(ran):
    class FakeCloud:
        def count(self):
            return 7

    class FakeEngine:
        cloud = FakeCloud()
        stats = []

    def fake_reconstruct(prefix, name, p_cap=0, log=print, **kw):
        ran.append((name, kw.get("device")))
        return FakeEngine()
    return fake_reconstruct


def test_discover_and_assign(tmp_path):
    root = str(tmp_path)
    names = _make_tree(root, 5)
    assert discover_options(root) == names
    # no pmvs.sh -> glob fallback, same order
    os.remove(os.path.join(root, "pmvs.sh"))
    assert discover_options(root) == names
    # round-robin covers every cluster exactly once across processes
    parts = [assign_clusters(names, i, 2) for i in range(2)]
    assert parts[0] == ["option-0000", "option-0002", "option-0004"]
    assert parts[1] == ["option-0001", "option-0003"]
    assert sorted(sum(parts, [])) == names
    assert clusters.process_topology() == (0, 1)


@pytest.mark.parametrize("plys", [True, False])
def test_merge_models(tmp_path, plys):
    """The port's merge of a tree equals the JAX package's, byte for byte
    (.patch, .pset, .ply; with the per-cluster PLYs' vertex lines, and
    without them the gray fallback)."""
    trees = {}
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        _make_tree(root, 3)
        if not plys:
            for f in os.listdir(os.path.join(root, "models")):
                if f.endswith(".ply"):
                    os.remove(os.path.join(root, "models", f))
        trees[name] = root
    jax_merge(trees["jax"])
    out = merge_models(trees["port"])
    assert out == os.path.join(trees["port"], "models", "all")
    for ext in ("patch", "pset", "ply"):
        assert filecmp.cmp(os.path.join(trees["jax"], "models", "all." + ext),
                           out + "." + ext, shallow=False), ext
    recs = read_patch_file(out + ".patch")
    assert len(recs) == 6
    xyz = read_ply_xyz(out + ".ply")
    assert xyz.shape == (6, 3)
    np.testing.assert_allclose(sorted(xyz[:, 0]), [0, 0, 1, 1, 2, 2])
    assert read_pset(out + ".pset")[0].shape == (6, 3)


def test_run_clusters_resume_skip(tmp_path, monkeypatch):
    root = str(tmp_path)
    names = _make_tree(root, 3)
    ran = []
    monkeypatch.setattr(engine, "reconstruct", _fake_engine(ran))
    # mark cluster 1 complete; process 0/1 owns everything
    with open(os.path.join(root, "models", names[1] + ".done"), "w") as f:
        f.write("1 0\n")
    runs = run_clusters(root, process_index=0, process_count=1,
                        checkpoint=True, device="cpu", **QUIET)
    cpu = torch.device("cpu")    # the rank's device (comm.rank_device)
    assert ran == [(names[0], cpu), (names[2], cpu)]
    assert [r.skipped for r in runs] == [False, True, False]
    assert runs[0].patches == 7
    # all done markers now exist -> second invocation runs nothing
    ran.clear()
    run_clusters(root, process_index=0, process_count=1, checkpoint=True,
                 **QUIET)
    assert ran == []


def test_cli_argv(tmp_path, monkeypatch):
    """The JAX CLIs' positional argv, plus --device."""
    calls = []
    import cmvs_pmvs_tpu_torch.models.cmvs as cmvs
    import cmvs_pmvs_tpu_torch.models.gen_option as gen
    monkeypatch.setattr(cmvs, "run_cmvs",
                        lambda *a, **kw: calls.append(("cmvs", a, kw)))
    monkeypatch.setattr(gen, "gen_option",
                        lambda *a, **kw: calls.append(("gen", a, kw)))
    assert cli_cmvs.main(["p"]) == 0
    assert cli_cmvs.main(["p", "5", "2", "--device", "cpu"]) == 0
    assert cli_gen.main(["p"]) == 0
    assert cli_gen.main(["p", "0", "3", "0.5", "9", "2", "4"]) == 0
    assert calls == [
        ("cmvs", ("p",), dict(maximage=100, device="cuda")),
        ("cmvs", ("p",), dict(maximage=5, device="cpu")),
        ("gen", ("p", 1, 2, 0.7, 7, 3, 8), {}),
        ("gen", ("p", 0, 3, 0.5, 9, 2, 4), {})]

    root = str(tmp_path)
    names = _make_tree(root, 3)
    ran = []
    monkeypatch.setattr(engine, "reconstruct", _fake_engine(ran))
    assert cli_all.main([root, "1", "2", "--device", "cpu"]) == 0
    assert ran == [(names[1], torch.device("cpu"))]
    assert not os.path.exists(os.path.join(root, "models", "all.patch"))
    ran.clear()
    assert cli_all.main([root, "--no-merge", "--device", "cpu"]) == 0
    assert [n for n, _ in ran] == [names[0], names[2]]   # 1 is done
    assert not os.path.exists(os.path.join(root, "models", "all.patch"))
    assert cli_all.main([root, "0", "1", "--device", "cpu"]) == 0
    assert len(read_patch_file(
        os.path.join(root, "models", "all.patch"))) == 6


def test_cli_default_device_needs_cuda(tmp_path, monkeypatch):
    """cmvs3-torch and pmvs3_all-torch raise without CUDA unless given
    --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path)
    scene = make_occluded_scene(num_cameras=4, width=80, height=60,
                                focal=90.0)
    write_pmvs_tree(scene, root)
    write_bundle_file(scene, root, num_points=60)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_cmvs.main([root, "3"])
    assert not os.path.exists(os.path.join(root, "ske.dat"))
    assert cli_cmvs.main([root, "3", "--device", "cpu"]) == 0
    assert read_ske(os.path.join(root, "ske.dat"))[0] == 4
    assert cli_gen.main([root, "0"]) == 0
    ran = []
    monkeypatch.setattr(engine, "reconstruct", _fake_engine(ran))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_all.main([root])
    assert ran == []
    assert cli_all.main([root, "--device", "cpu", "--no-merge"]) == 0
    assert ran


def test_console_scripts_registered():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert {k: v for k, v in scripts.items() if k.endswith("-torch")} == {
        "pmvs3-torch": "cmvs_pmvs_tpu_torch.cli.pmvs:main",
        "cmvs3-torch": "cmvs_pmvs_tpu_torch.cli.cmvs:main",
        "genOption-torch": "cmvs_pmvs_tpu_torch.cli.genoption:main",
        "pmvs3_all-torch": "cmvs_pmvs_tpu_torch.cli.pmvs_all:main"}


def test_pmvs3_all_end_to_end(tmp_path):
    """cmvs3 -> genOption -> pmvs3_all -> merge on the CPU: an occluded
    scene (12 views, 160x120) whose SfM points cover +-2.5 of the ground,
    so each camera sees a part of them; maximage 6 gives two clusters.
    Every cluster reconstructs patches, the merged files hold their sum,
    and the merged cloud passes the protocol's accuracy bars."""
    root = str(tmp_path)
    scene = make_occluded_scene(num_cameras=12, width=160, height=120,
                                focal=175.0)
    write_pmvs_tree(scene, root, mask_border=2)
    write_bundle_file(scene, root, extent=2.5)
    assert cli_cmvs.main([root, "6", "--device", "cpu"]) == 0
    assert cli_gen.main([root, "0", "2", "0.7", "7", "3"]) == 0
    _, timages, _ = read_ske(os.path.join(root, "ske.dat"))
    assert len(timages) >= 2 and all(0 < len(t) <= 6 for t in timages)
    runs = run_clusters(root, device="cpu", p_cap=20_000, expand_iters=1,
                        max_waves=1, refine_iters=4, **QUIET)
    assert [r.name for r in runs] == discover_options(root)
    assert all(r.patches > 0 for r in runs)
    out = merge_models(root)
    total = sum(r.patches for r in runs)
    recs = read_patch_file(out + ".patch")
    assert len(recs) == total
    assert len(read_ply_xyz(out + ".ply")) == total
    assert len(read_pset(out + ".pset")[0]) == total
    xyz = np.array([r.coord[:3] for r in recs])
    d = scene.surface_distance(xyz) / np.array([r.dscale for r in recs])
    assert np.median(d) < 0.4 and np.quantile(d, 0.9) < 1.5

"""The port's own copies of the JAX package's jax-free modules (io/,
utils/options.py, utils/synthetic.py) against the originals: the same
arguments give bit-equal scenes, byte-identical files and equal parsed
options."""
import dataclasses
import filecmp
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cmvs_pmvs_tpu.io import cameras as JCAM  # noqa: E402
from cmvs_pmvs_tpu.io import images as JIMG  # noqa: E402
from cmvs_pmvs_tpu.io import patches as JPAT  # noqa: E402
from cmvs_pmvs_tpu.io import ply as JPLY  # noqa: E402
from cmvs_pmvs_tpu.utils import options as JOPT  # noqa: E402
from cmvs_pmvs_tpu.utils import synthetic as JSYN  # noqa: E402

from cmvs_pmvs_tpu_torch.io import cameras as TCAM  # noqa: E402
from cmvs_pmvs_tpu_torch.io import images as TIMG  # noqa: E402
from cmvs_pmvs_tpu_torch.io import patches as TPAT  # noqa: E402
from cmvs_pmvs_tpu_torch.io import ply as TPLY  # noqa: E402
from cmvs_pmvs_tpu_torch.io import writers as TW  # noqa: E402
from cmvs_pmvs_tpu_torch.utils import options as TOPT  # noqa: E402
from cmvs_pmvs_tpu_torch.utils import synthetic as TSYN  # noqa

SCENES = ["make_plane_scene", "make_occluded_scene", "make_textured_scene"]


def _same_files(a, b):
    assert filecmp.cmp(a, b, shallow=False), (a, b)


@pytest.mark.parametrize("name", SCENES)
def test_scene_generators_bit_equal(name):
    kw = dict(num_cameras=3, width=48, height=36, focal=60.0, seed=3)
    want = getattr(JSYN, name)(**kw)
    got = getattr(TSYN, name)(**kw)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), f.name)


def test_write_pmvs_tree_byte_identical(tmp_path):
    scene = TSYN.make_occluded_scene(num_cameras=2, width=40, height=30,
                                     focal=50.0)
    JSYN.write_pmvs_tree(scene, str(tmp_path / "jax"), mask_border=3)
    TSYN.write_pmvs_tree(scene, str(tmp_path / "port"), mask_border=3)
    for sub in ("visualize", "txt", "masks"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub))
        for n in names:
            _same_files(tmp_path / "jax" / sub / n,
                        tmp_path / "port" / sub / n)
    path = str(tmp_path / "port" / "visualize" / "00000001.ppm")
    np.testing.assert_array_equal(TIMG.load_image(path),
                                  JIMG.load_image(path))
    mpath = str(tmp_path / "port" / "masks" / "00000000.pgm")
    np.testing.assert_array_equal(TIMG.load_pgm_mask(mpath),
                                  JIMG.load_pgm_mask(mpath))
    cpath = str(tmp_path / "port" / "txt" / "00000000.txt")
    np.testing.assert_array_equal(TCAM.read_camera_txt(cpath),
                                  JCAM.read_camera_txt(cpath))


def _cloud(dtype):
    rng = np.random.default_rng(11)
    n = 257
    coord = np.concatenate([rng.normal(size=(n, 3)), np.ones((n, 1))], 1)
    normal = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1))], 1)
    ids = rng.integers(-1, 40, (n, 6))
    ids[0] = -1
    return (coord.astype(dtype), normal.astype(dtype),
            rng.uniform(-1, 1, n).astype(dtype),
            rng.uniform(0, 3, n).astype(dtype),
            rng.uniform(0, 1, n).astype(dtype), ids, ids[:, ::-1].copy())


def _same_cloud_files(tmp_path, coord, normal, ncc, dscale, ascale, images,
                      vimages) -> str:
    """Write the cloud's .patch, .pset and .ply (grey and coloured) through
    the JAX package's Python writers and the port's, and require the same
    bytes; returns the port's files' prefix."""
    recs = [JPAT.PatchRecord(
        coord=coord[k], normal=normal[k], ncc=float(ncc[k]),
        dscale=float(dscale[k]), ascale=float(ascale[k]),
        images=[int(i) for i in images[k] if i >= 0],
        vimages=[int(i) for i in vimages[k] if i >= 0])
        for k in range(len(coord))]
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    JPAT.write_patch_file(j + ".patch", recs)
    TPAT.write_patch_arrays(t + ".patch", coord, normal, ncc, dscale, ascale,
                            images, vimages)
    _same_files(j + ".patch", t + ".patch")
    JPAT.write_pset(j + ".pset", coord[:, :3], normal[:, :3],
                    force_python=True)
    TPAT.write_pset(t + ".pset", coord[:, :3], normal[:, :3])
    _same_files(j + ".pset", t + ".pset")
    colors = np.random.default_rng(2).uniform(-5, 260, (len(coord), 3))
    for col in (None, colors):
        JPLY.write_patch_ply(j + ".ply", coord[:, :3], normal[:, :3],
                             colors=col, quality=ncc, force_python=True)
        TPLY.write_patch_ply(t + ".ply", coord[:, :3], normal[:, :3],
                             colors=col, quality=ncc)
        _same_files(j + ".ply", t + ".ply")
    return t


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cloud_writers_byte_identical(tmp_path, dtype):
    coord, normal, ncc, dscale, ascale, images, vimages = _cloud(dtype)
    t = _same_cloud_files(tmp_path, coord, normal, ncc, dscale, ascale,
                          images, vimages)
    back = TPAT.read_patch_file(t + ".patch")
    assert len(back) == len(coord) and back[0].images == []
    np.testing.assert_array_equal(TPLY.read_ply_xyz(t + ".ply"),
                                  JPLY.read_ply_xyz(t + ".ply"))


def test_empty_cloud_writers(tmp_path):
    z = np.zeros((0, 4), np.float32)
    ids = np.zeros((0, 6), np.int64)
    TPAT.write_patch_arrays(str(tmp_path / "e.patch"), z, z, z[:, 0],
                            z[:, 0], z[:, 0], ids, ids)
    JPAT.write_patch_file(str(tmp_path / "j.patch"), [])
    _same_files(tmp_path / "e.patch", tmp_path / "j.patch")


def _edge_cloud(case, dtype):
    """Six patches whose floats or ids hit one edge case of the text
    formats: every third value special, so each column gets some; or,
    for "threads", enough patches that the writers split the rows over
    two threads."""
    rng = np.random.default_rng(5)
    n = {"empty": 0, "threads": 2 * 8192 + 3}.get(case, 6)
    k = 0 if case == "width0" else 4
    heads = rng.normal(size=(n, 11))
    tiny = np.finfo(dtype).smallest_subnormal
    special = {
        "nan": [np.nan, np.copysign(np.nan, -1.0), 1.5],
        "inf_zero": [np.inf, -np.inf, 0.0, -0.0],
        "subnormal": [tiny, -tiny, 2 * tiny],
        # where %g switches to the exponent form: 1e-5 and 1e16-1e17 for
        # 17 digits, 1e9 for 9
        "g_switch": [1e-5, 9.999999999999999e-06, 1.0000000000000001e-05,
                     9.99995e-5, 1e-4, 1e16, 9999999999999998.0, 1e17,
                     99999999999999999.0, 999999999.5, 1e9, 99999999.95,
                     123456789.0, 1.2345678912345678e-5],
    }.get(case)
    if special is not None:
        heads.flat[::3] = np.resize(special, heads.flat[::3].shape)
    heads = heads.astype(dtype)
    ids = rng.integers(0, 40, (n, k))
    if case == "ids_negative":
        ids[2] = -1
        ids[4, ::2] = -1
    if case == "big_ids":
        ids = ids * 1_234_567 + 9_999
    return heads, ids, ids[:, ::-1].copy()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["nan", "inf_zero", "subnormal", "g_switch",
                                  "ids_negative", "width0", "big_ids",
                                  "empty", "threads"])
def test_cloud_writers_edge_cases(tmp_path, case, dtype):
    """The port's C++ writers against the JAX package's Python writers on
    NaN of either sign, infinities, signed zeros, subnormals, the values
    where %g changes form, rows without ids, no id columns, large ids, an
    empty cloud and rows split over threads: byte-identical .patch, .pset
    and .ply files."""
    heads, images, vimages = _edge_cloud(case, dtype)
    if case == "nan":
        assert np.signbit(heads[np.isnan(heads)]).any()
    _same_cloud_files(tmp_path, heads[:, :4], heads[:, 4:8], heads[:, 8],
                      heads[:, 9], heads[:, 10], images, vimages)


def test_writer_library_builds_once(tmp_path, monkeypatch):
    """Two processes build the writer library into one empty directory at
    once: both name the same hashed file and leave no pid-tagged
    temporary file. A later build finds that file and leaves it as it
    is."""
    code = ("import sys\n"
            "from pathlib import Path\n"
            "from cmvs_pmvs_tpu_torch.io import writers as W\n"
            "W.BUILD_DIR = Path(sys.argv[1])\n"
            "print(W.build())\n"
            "W.lib()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    libs = {o.strip() for o, _ in outs}
    assert len(libs) == 1
    lib = Path(libs.pop())
    assert sorted(os.listdir(tmp_path)) == [lib.name]
    before = lib.stat()
    monkeypatch.setattr(TW, "BUILD_DIR", tmp_path)
    assert TW.build() == lib
    after = lib.stat()
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino,
                                                 before.st_mtime_ns)


def test_package_data_ships_every_csrc_source():
    """An installed package carries every file under csrc/: the kernels'
    and the writers' sources are compiled at first use."""
    root = Path(__file__).resolve().parents[1]
    pkg = root / "cmvs_pmvs_tpu_torch"
    conf = tomllib.loads((root / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"]["cmvs_pmvs_tpu_torch"]
    shipped = {f for g in globs for f in pkg.glob(g)}
    sources = {f for f in (pkg / "csrc").iterdir() if f.is_file()}
    assert pkg / "csrc" / "writers.cpp" in sources
    assert sources <= shipped, sorted(map(str, sources - shipped))


OPTION = """# comment line
level 1  csize 2
threshold 0.65 wsize 9   # trailing comment
minImageNum 2
CPU 8
setEdge 0.25
useBound 0
useVisData 1
sequence 3
maxAngle 12.5
quad 2.0
timages -1 0 4
oimages -2
"""


def test_option_files_parse_alike(tmp_path):
    path = tmp_path / "option.txt"
    path.write_text(OPTION)
    with open(tmp_path / "vis.dat", "w") as f:
        f.write("VISDATA\n6\n0 2 1 4\n1 2 0 5\n2 1 3\n3 1 2\n4 1 0\n"
                "5 1 1\n")
    want = JOPT.PMVSOptions.parse(str(path))
    got = TOPT.PMVSOptions.parse(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    want = want.resolve_oimages(str(tmp_path))
    got = got.resolve_oimages(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.oimages == [4, 5]
    assert TOPT.build_visdata(got, str(tmp_path)) == \
        JOPT.build_visdata(want, str(tmp_path))
    got.write(str(tmp_path / "t.txt"), comment="c")
    want.write(str(tmp_path / "j.txt"), comment="c")
    _same_files(tmp_path / "t.txt", tmp_path / "j.txt")
    with open(tmp_path / "bimages.dat", "w") as f:
        f.write("3 1 2 9\n")
    assert TOPT.read_bimages(str(tmp_path), [0, 1, 2, 3]) == \
        JOPT.read_bimages(str(tmp_path), [0, 1, 2, 3])

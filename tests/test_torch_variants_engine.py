"""The port's engine against the JAX engine with a gamma-decoded pyramid
(FURUKAWA_IMAGE_GAMMA, `build_pyramids(..., gamma=2.2)` in the SceneData,
as the JAX package reaches it). Unblocked bilinear grabs and bicubic
sampling are in test_torch_unblocked_engine.py and
test_torch_bicubic_engine.py (one variant a file, to keep each file
near a minute or two on one CPU); the runner and the bars are here.

Both packages reconstruct test_torch_pipeline.py's 5-camera 128x96 plane
scene on the CPU (the port through its CPU path: central-difference LM,
plain windows), with its bars: patch counts within 10%, both medians of
plane distance / dscale < 0.3 and within 0.05 of each other. On gamma
also: detection on the float atlas (the same features), the written
.ply colors (`_patch_colors`, the JAX engine's formula on the same
cloud within 1e-5) and the outputs read back.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import cmvs_pmvs_tpu.models.engine as JE  # noqa: E402
import cmvs_pmvs_tpu.ops.texture as JT  # noqa: E402
from cmvs_pmvs_tpu.image.pyramid import build_pyramids as jax_pyramids  # noqa
from cmvs_pmvs_tpu.io.ply import read_ply_xyz  # noqa: E402
from cmvs_pmvs_tpu.ops.detect import detect_features as jax_detect  # noqa
from cmvs_pmvs_tpu.utils.options import PMVSOptions as JaxOptions  # noqa
from cmvs_pmvs_tpu.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

import cmvs_pmvs_tpu_torch.models.engine as TE  # noqa: E402
import cmvs_pmvs_tpu_torch.ops.texture as TT  # noqa: E402
import cmvs_pmvs_tpu_torch.ops.windows as TW  # noqa: E402
from cmvs_pmvs_tpu_torch import convert  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.detect import detect_features  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402

OPTION = ("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\nCPU 4\n"
          "setEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
          "timages -1 0 5\noimages 0\n")
RUN = dict(expand_iters=1, max_waves=2, refine_iters=8)
GAMMA = 2.2
# each variant: (texture.SAMPLING, texture._USE_BLOCK_SAMPLING, gamma)
VARIANTS = {"gamma": ("bilinear", True, GAMMA),
            "unblocked": ("bilinear", False, None),
            "bicubic": ("bicubic", True, None)}


def write_scene(root: str):
    scene = make_plane_scene(num_cameras=5, width=128, height=96)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write(OPTION)
    return scene


class Route:
    """Records, over the port's run, what its grabs sampled with: each
    call of the windows/K4 plain versions' sampler (ops/windows.
    block_bilinear) by (atlas dtype, blocked), and the bicubic sampler's
    calls (ops/texture.bicubic_color)."""

    def __init__(self):
        self.block = {}
        self.bicubic = 0

    def __enter__(self):
        self.saved = TW.block_bilinear, TT.bicubic_color

        def block(atlas, *args, **kwargs):
            key = (str(atlas.dtype).split(".")[1],
                   kwargs.get("blocked", args[6] if len(args) > 6 else True))
            self.block[key] = self.block.get(key, 0) + 1
            return self.saved[0](atlas, *args, **kwargs)

        def bicubic(*args, **kwargs):
            self.bicubic += 1
            return self.saved[1](*args, **kwargs)

        TW.block_bilinear, TT.bicubic_color = block, bicubic
        return self

    def __exit__(self, *exc):
        TW.block_bilinear, TT.bicubic_color = self.saved


def reconstruct_variant(pkg: str, root: str, variant: str):
    """Reconstruct `root`'s scene with the JAX engine or the port's (CPU)
    under `variant`, the texture switches set for the run and restored
    after, and write models/option.txt. The JAX jit caches are cleared
    around the run: the switches are read while tracing, so a function
    traced under the default switches must not be reused. Returns the
    engine and, for the port, its Route."""
    sampling, blocked, gamma = VARIANTS[variant]
    jax_side = pkg == "jax"
    tex = JT if jax_side else TT
    saved = tex.SAMPLING, tex._USE_BLOCK_SAMPLING
    if jax_side:
        jax.clear_caches()
    tex.SAMPLING, tex._USE_BLOCK_SAMPLING = sampling, blocked
    route = Route()
    try:
        if jax_side:
            opt = JaxOptions.parse(os.path.join(root, "option.txt"))
            data = JE.load_scene(root, opt)
            if gamma is not None:
                data = dataclasses.replace(data, pyr=jax_pyramids(
                    data.images, None, data.pyr.num_levels, gamma=gamma))
            eng = JE.PMVSEngine(data, opt, p_cap=6000, log=lambda *a: None)
        else:
            opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
            data = TE.load_scene(root, opt, device="cpu")
            if gamma is not None:
                data = dataclasses.replace(data, pyr=build_pyramids(
                    data.images, None, data.pyr.num_levels, device="cpu",
                    gamma=gamma))
            eng = TE.PMVSEngine(data, opt, p_cap=6000, log=lambda *a: None,
                                device="cpu")
        with route:
            eng.run(**RUN)
        out = os.path.join(root, "models", "option.txt")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        eng.write(out)
    finally:
        tex.SAMPLING, tex._USE_BLOCK_SAMPLING = saved
        if jax_side:
            jax.clear_caches()
    return eng, route


def alive_cloud(eng) -> dict:
    alive = np.asarray(eng.cloud.alive)
    return {k: np.asarray(getattr(eng.cloud, k))[alive]
            for k in ("coord", "dscale")}


def median_offset(scene, cloud) -> float:
    return float(np.median(scene.plane_distance(cloud["coord"][:, :3])
                           / cloud["dscale"]))


def check_bars(scene, jax_cloud, port_cloud):
    """test_torch_pipeline.py's bars."""
    nj, nt = len(jax_cloud["coord"]), len(port_cloud["coord"])
    assert nj > 300 and abs(nt - nj) <= 0.1 * nj, (nt, nj)
    mj = median_offset(scene, jax_cloud)
    mt = median_offset(scene, port_cloud)
    assert mj < 0.3 and mt < 0.3, (mj, mt)
    assert abs(mj - mt) < 0.05, (mj, mt)


def read_ply_colors(path: str) -> np.ndarray:
    """The diffuse_{red,green,blue} columns of an ASCII patch .ply."""
    with open(path) as f:
        lines = f.read().splitlines()
    start = lines.index("end_header") + 1
    return np.array([[int(v) for v in ln.split()[6:9]]
                     for ln in lines[start:]], np.int64).reshape(-1, 3)


def run_both(tmp_path_factory, variant: str):
    """{pkg: (root, engine, route)} of both packages' runs of `variant`,
    and the scene."""
    out = {}
    for pkg in ("jax", "torch"):
        root = str(tmp_path_factory.mktemp(f"{variant}_{pkg}"))
        scene = write_scene(root)
        out[pkg] = (root, *reconstruct_variant(pkg, root, variant))
    return scene, out


@pytest.fixture(scope="module")
def gamma(tmp_path_factory):
    return run_both(tmp_path_factory, "gamma")


def check_run(variant, scene, out, sampled):
    """The bars, the outputs read back, and the port's grabs routed by
    the variant: every plain window sampled with `sampled` = (atlas
    dtype, blocked), and no bicubic sample."""
    check_bars(scene, alive_cloud(out["jax"][1]),
               alive_cloud(out["torch"][1]))
    root, eng, route = out["torch"]
    assert eng.scene.pyr.byte_valued == (variant != "gamma")
    assert set(route.block) == {sampled} and route.bicubic == 0
    base = os.path.join(root, "models", "option.txt")
    n = int(eng.cloud.count())
    assert len(read_ply_xyz(base + ".ply")) == n
    assert len(read_ply_colors(base + ".ply")) == n


def test_gamma_meets_pipeline_bars(gamma):
    """On gamma every plain window sampled the float32 atlas (blocked)."""
    check_run("gamma", *gamma, ("float32", True))


def test_gamma_detection_on_the_float_atlas(gamma):
    """Both packages detect the same features on the gamma atlas (the
    engine's detection input, engine.py:219), as on bytes
    (test_torch_models.py's bar: >= 98% of positions equal)."""
    _, out = gamma
    jp = out["jax"][1].scene.pyr
    tp = out["torch"][1].scene.pyr
    h, w = int(tp.heights[0].max()), int(tp.widths[0].max())
    want = jax_detect(jp.atlas[:, :h, :w], jp.mask_atlas[:, :h, :w]
                      * jp.edge_atlas[:, :h, :w], jp.widths[0],
                      jp.heights[0], fcsize=16)
    got = detect_features(tp.atlas[:, :h, :w], tp.mask_atlas[:, :h, :w]
                          * tp.edge_atlas[:, :h, :w], tp.widths[0],
                          tp.heights[0], fcsize=16)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.sum() > 50
    same = ((got["x"].numpy() == np.asarray(want["x"]))
            & (got["y"].numpy() == np.asarray(want["y"])))[valid]
    assert same.mean() >= 0.98, same.mean()


def test_gamma_ply_colors(gamma):
    """The port's `_patch_colors` on the JAX engine's gamma cloud equals
    the JAX engine's within 1e-5, and each package's .ply carries its
    colors rounded (gamma colors lie in [0, 1], so the file holds 0s and
    1s, as the reference package writes them)."""
    _, out = gamma
    jeng, teng = out["jax"][1], out["torch"][1]
    jidx = np.nonzero(np.asarray(jeng.cloud.alive))[0]
    want = np.asarray(jeng._patch_colors(jidx))
    saved = teng.cloud
    try:
        teng.cloud = convert.cloud_from_numpy(
            {f.name: np.asarray(getattr(jeng.cloud, f.name))
             for f in dataclasses.fields(jeng.cloud)})
        got = teng._patch_colors(torch.tensor(jidx))
    finally:
        teng.cloud = saved
    assert want.max() <= 1.0 and want.max() > 0.2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for pkg, eng in (("jax", jeng), ("torch", teng)):
        idx = np.nonzero(np.asarray(eng.cloud.alive))[0]
        cols = (eng._patch_colors(idx) if pkg == "jax"
                else eng._patch_colors(torch.tensor(idx)))
        written = read_ply_colors(os.path.join(out[pkg][0], "models",
                                               "option.txt.ply"))
        np.testing.assert_array_equal(
            written, np.clip(np.floor(np.asarray(cols) + 0.5), 0, 255))

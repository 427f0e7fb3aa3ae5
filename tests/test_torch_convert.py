"""State carried from the JAX package into the port (convert.py) and the
shared checkpoint layout, field by field and exact."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cmvs_pmvs_tpu.geom import build_camera_set as jax_cameras  # noqa: E402
from cmvs_pmvs_tpu.image import build_pyramids as jax_pyramids  # noqa: E402
from cmvs_pmvs_tpu.models.engine import (  # noqa: E402
    PMVSEngine as JaxEngine, load_scene as jax_load_scene)
from cmvs_pmvs_tpu.utils.options import PMVSOptions  # noqa: E402
from cmvs_pmvs_tpu.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

from cmvs_pmvs_tpu_torch import convert  # noqa: E402
from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.models.engine import (  # noqa: E402
    PMVSEngine, load_scene)


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x)}


def _assert_same(port, arrays):
    for f in dataclasses.fields(port):
        got = getattr(port, f.name)
        if not isinstance(got, torch.Tensor):
            continue
        want = np.asarray(arrays[f.name]).astype(got.numpy().dtype)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("conv"))
    scene = make_plane_scene(num_cameras=5, width=64, height=48)
    write_pmvs_tree(scene, root)
    path = os.path.join(root, "option.txt")
    with open(path, "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "timages -1 0 5\noimages 0\n")
    opt = PMVSOptions.parse(path)
    jeng = JaxEngine(jax_load_scene(root, opt), opt, p_cap=64,
                     log=lambda *a: None)
    # fill the JAX state with non-trivial values
    rng = np.random.default_rng(0)
    cloud = jeng.cloud
    jeng.cloud = dataclasses.replace(
        cloud,
        coord=jnp.asarray(rng.normal(size=cloud.coord.shape), jnp.float32),
        images=jnp.asarray(rng.integers(-1, 5, cloud.images.shape),
                           jnp.int32),
        alive=jnp.asarray(rng.random(cloud.capacity) < 0.5),
        ncc=jnp.asarray(rng.random(cloud.capacity), jnp.float32))
    jeng.grid = dataclasses.replace(
        jeng.grid, counts=jnp.asarray(rng.integers(0, 9, jeng.grid.shape),
                                      jnp.int32))
    jeng.thr = jeng.thr.relaxed()
    teng = PMVSEngine(load_scene(root, opt, device="cpu"), opt, p_cap=64,
                      log=lambda *a: None, device="cpu")
    return root, jeng, teng


def test_jax_checkpoint_loads_field_by_field(engines, tmp_path):
    _, jeng, teng = engines
    path = str(tmp_path / "ck.npz")
    jeng.save_checkpoint(path, iteration=2)
    cloud, grid, thr, it = convert.engine_state_from_jax_checkpoint(path)
    assert it == 2
    _assert_same(cloud, _fields(jeng.cloud))
    _assert_same(grid, _fields(jeng.grid))
    _assert_same(thr, _fields(jeng.thr))
    assert cloud.images.dtype == torch.int32 and cloud.alive.dtype == \
        torch.bool
    assert teng.load_checkpoint(path) == 2
    _assert_same(teng.cloud, _fields(jeng.cloud))


def test_port_checkpoint_loads_into_jax(engines, tmp_path):
    """The port writes the reference's npz layout."""
    _, jeng, teng = engines
    path = str(tmp_path / "ck2.npz")
    jeng.save_checkpoint(path, iteration=1)
    teng.load_checkpoint(path)
    out = str(tmp_path / "ck3.npz")
    teng.save_checkpoint(out, iteration=1)
    assert jeng.load_checkpoint(out) == 1
    _assert_same(teng.cloud, _fields(jeng.cloud))
    _assert_same(teng.thr, _fields(jeng.thr))


def test_cameras_and_pyramid_from_numpy():
    scene = make_plane_scene(num_cameras=4, width=64, height=48)
    jc = jax_cameras(scene.P, dtype=jnp.float32)
    cams = convert.camera_set_from_numpy(_fields(jc))
    _assert_same(cams, _fields(build_camera_set(scene.P)))
    jp = jax_pyramids(list(scene.images), None, 3)
    fields = _fields(jp)
    fields["num_levels"] = jp.num_levels
    pyr = convert.pyramid_from_numpy(fields)
    ref = build_pyramids(list(scene.images), None, 3)
    _assert_same(pyr, {f.name: getattr(ref, f.name).numpy()
                       for f in dataclasses.fields(ref)
                       if f.name not in ("num_levels", "byte_valued")})
    assert pyr.num_levels == 3 and pyr.byte_valued


def test_port_checkpoint_resume(engines, tmp_path):
    """A run resumed from the port's own checkpoint continues with the
    saved cloud and thresholds (run(start_iter=...))."""
    root, _, _ = engines
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    first = PMVSEngine(load_scene(root, opt, device="cpu"), opt, p_cap=2000,
                       log=lambda *a: None, device="cpu")
    first.run(expand_iters=1, max_waves=1, refine_iters=4)
    n1 = int(first.cloud.count())
    path = str(tmp_path / "resume.npz")
    first.save_checkpoint(path, iteration=1)
    second = PMVSEngine(load_scene(root, opt, device="cpu"), opt,
                        p_cap=2000, log=lambda *a: None, device="cpu")
    it = second.load_checkpoint(path)
    assert it == 1 and int(second.cloud.count()) == n1 > 0
    np.testing.assert_array_equal(second.thr.ncc.numpy(),
                                  first.thr.ncc.numpy())
    second.run(expand_iters=2, max_waves=1, refine_iters=4, start_iter=it)
    assert len(second.stats) == 1 and second.stats[0]["iter"] == 1
    assert int(second.cloud.count()) > 0

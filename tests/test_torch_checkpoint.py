"""Checkpoint/resume of the port's engine state, and the checkpoint file
across the two packages.

The first case is tests/test_checkpoint.py's round trip on the port's
engine (CPU). The others hold `PMVSEngine.save_checkpoint` /
`load_checkpoint` to the claim that the port writes and reads the JAX
engine's npz layout: the same arrays by name, shape and dtype, and a
file written by either engine loads into the other with every array
equal. The JAX engine's state is built with 64-bit types off, as the
JAX package runs outside this suite (the suite's conftest turns them on,
which makes the JAX engine's grid depths float64).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cmvs_pmvs_tpu.models.engine import PMVSEngine as JaxEngine  # noqa
from cmvs_pmvs_tpu.models.engine import load_scene as jax_load_scene  # noqa
from cmvs_pmvs_tpu.utils.options import PMVSOptions as JaxOptions  # noqa

from cmvs_pmvs_tpu_torch.models.engine import PMVSEngine, load_scene  # noqa
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

P_CAP = 100
STATE = ("cloud", "grid", "thr")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    write_pmvs_tree(make_plane_scene(num_cameras=4, width=64, height=48),
                    root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "useVisData 0\ntimages -1 0 4\noimages 0\n")
    return root


def _port_engine(root):
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    return PMVSEngine(load_scene(root, opt, device="cpu"), opt, p_cap=P_CAP,
                      log=lambda *a: None, device="cpu")


def _jax_engine(root):
    opt = JaxOptions.parse(os.path.join(root, "option.txt"))
    with jax.enable_x64(False):
        return JaxEngine(jax_load_scene(root, opt), opt, p_cap=P_CAP,
                         log=lambda *a: None)


def _arrays(eng) -> dict:
    """Every state array of an engine of either package, as numpy."""
    return {f"{prefix}_{f.name}": np.asarray(
        getattr(getattr(eng, prefix), f.name))
        for prefix in STATE
        for f in dataclasses.fields(getattr(eng, prefix))}


def _assert_same_state(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_checkpoint_roundtrip(tree):
    eng = _port_engine(tree)
    eng.cloud.coord[0] = torch.tensor([1.0, 2.0, 3.0, 1.0])
    eng.cloud.alive[0] = True
    eng.thr = eng.thr.relaxed()
    ckpt = os.path.join(tree, "state_port.npz")
    eng.save_checkpoint(ckpt, iteration=2)

    eng2 = _port_engine(tree)
    it = eng2.load_checkpoint(ckpt)
    assert it == 2
    assert bool(eng2.cloud.alive[0])
    np.testing.assert_allclose(eng2.cloud.coord[0].numpy(), [1, 2, 3, 1])
    assert abs(float(eng2.thr.ncc) - (0.7 - 0.05)) < 1e-6
    assert eng2.cloud.coord.device == torch.device("cpu")
    _assert_same_state(_arrays(eng2), _arrays(eng))


def _fabricate_jax(eng):
    c, g = eng.cloud, eng.grid
    with jax.enable_x64(False):
        eng.cloud = dataclasses.replace(
            c, coord=c.coord.at[3].set(jnp.asarray([0.5, -1.0, 2.0, 1.0])),
            images=c.images.at[3, :2].set(jnp.asarray([1, 2],
                                                      c.images.dtype)),
            ncc=c.ncc.at[3].set(0.875), alive=c.alive.at[3].set(True))
        eng.grid = dataclasses.replace(
            g, depth_idx=g.depth_idx.at[0, 0, 0].set(3))
        eng.thr = eng.thr.relaxed()


def test_jax_checkpoint_loads_into_port(tree):
    jeng = _jax_engine(tree)
    _fabricate_jax(jeng)
    ckpt = os.path.join(tree, "state_jax.npz")
    jeng.save_checkpoint(ckpt, iteration=1)
    eng = _port_engine(tree)
    assert eng.load_checkpoint(ckpt) == 1
    _assert_same_state(_arrays(eng), _arrays(jeng))
    assert eng.p_cap == jeng.p_cap


def test_port_checkpoint_loads_into_jax(tree):
    eng = _port_engine(tree)
    eng.cloud.coord[7] = torch.tensor([-0.25, 0.5, 1.5, 1.0])
    eng.cloud.ncc[7] = 0.625
    eng.cloud.alive[7] = True
    eng.thr = eng.thr.relaxed()
    ckpt = os.path.join(tree, "state_port_to_jax.npz")
    eng.save_checkpoint(ckpt, iteration=2)
    jeng = _jax_engine(tree)
    assert jeng.load_checkpoint(ckpt) == 2
    _assert_same_state(_arrays(jeng), _arrays(eng))


def test_checkpoint_files_share_one_layout(tree):
    """The two engines' files hold the same arrays by name, shape and
    dtype."""
    paths = (os.path.join(tree, "layout_port.npz"),
             os.path.join(tree, "layout_jax.npz"))
    _port_engine(tree).save_checkpoint(paths[0])
    _jax_engine(tree).save_checkpoint(paths[1])
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k

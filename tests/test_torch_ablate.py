"""Port of the fan-kernel ablations (ops/ablate: the plain versions of
K5, K6 and K7) and of their drivers against the JAX ablation scripts.

The scripts under scripts/ are loaded with importlib; they set the
persistent compilation cache when imported, and the previous settings
are restored right after. Their Pallas kernels run in interpret mode on
inputs made with numpy from one seed at a small shape: 8 patches, 3
views (the scripts' module-level T set to 3), 4 patches per grid step,
a 3 x 60 x 90 atlas whose last tiles pass its edge. Sample positions
are multiples of 1/64 px, so every hat weight is exact in bf16, the
scripts' rounding of wy changes nothing, and K6/K7 are held to 1e-4
relative (f32 summation order). K5 still rounds its x-weighted rows to
bf16; its tolerance is derived below.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from cmvs_pmvs_tpu.ops import pallas_fan as JF  # noqa: E402
from cmvs_pmvs_tpu.ops import pallas_fan2 as JF2  # noqa: E402

from cmvs_pmvs_tpu_torch.ops import ablate as A  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.fan import incc_fan_v1_plain  # noqa: E402
from cmvs_pmvs_tpu_torch.scripts import ablate_common as AC  # noqa: E402
from cmvs_pmvs_tpu_torch.scripts import ablate_fan as D5  # noqa: E402
from cmvs_pmvs_tpu_torch.scripts import ablate_fan2 as D6  # noqa: E402
from cmvs_pmvs_tpu_torch.scripts import ablate_fan25 as D7  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, WA = 3, 60, 90
B, T, PPV, S2 = 8, 3, 4, 49
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")


def _load_script(name):
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def scripts():
    mods = {n: _load_script(n) for n in ("ablate_fan", "ablate_fan2",
                                         "ablate_fan25")}
    mods["ablate_fan2"].T = T
    mods["ablate_fan25"].T = T
    return mods


@pytest.fixture(scope="module")
def base():
    rng = np.random.default_rng(0)
    atlas = rng.integers(0, 255, (N, H, WA, 3), dtype=np.uint8)
    ty, tx = JF.tile_counts(H, WA)
    tilemap = ((rng.integers(0, N, B * T) << 20)
               | (rng.integers(0, ty, B * T) << 10)
               | rng.integers(0, tx, B * T)).astype(np.int32)
    return dict(rng=rng, atlas=atlas, tilemap=tilemap,
                tatlas=torch.tensor(atlas),
                ttm=torch.tensor(tilemap.reshape(B, T)))


def _q64(x):
    return np.round(np.asarray(x) * 64.0) / 64.0


# ---- K5 -------------------------------------------------------------------

FAN5 = 4


@pytest.fixture(scope="module")
def k5_geom(base):
    """geom [4, B*T*fan*4]: hi rows an integer origin and affine steps of
    0.75-1.25 px (+-0.25 px shear), lo rows a sub-pixel origin, all
    multiples of 1/64; windows reach 1-2 px past their tile."""
    rng = np.random.default_rng(5)
    p = B * T * FAN5
    g = np.zeros((4, p, 4), np.float32)
    g[0:2, :, 0] = rng.integers(2, 29, (2, p))
    g[2:4, :, 0] = _q64(rng.uniform(0, 1, (2, p)))
    g[0, :, 1], g[1, :, 2] = rng.choice([0.75, 1.0, 1.25], (2, p))
    g[1, :, 1], g[0, :, 2] = rng.choice([-0.25, 0.0, 0.25], (2, p))
    return g.reshape(4, p * 4)


def _bf16_incc_tol(base, geom):
    """Bound on |JAX K5 - f32 K5| per probe. The TPU kernel rounds each
    x-weighted row q >= 0 to bf16 (8-bit significand, unit roundoff 2^-9)
    before summing the two taps, so each sample moves by at most 2^-9 of
    itself: ||e|| <= 2^-9 ||w|| for a window w. Centring does not grow e,
    and a unit vector a / ||a|| moves by at most 2 ||e|| / ||a||; so the
    NCC moves by at most 2^-8 (||w_v|| / ||a_v|| + ||w_r|| / ||a_r||)
    (a = w - its channel means), and INCC = x / (1 + 3x), x = 1 - NCC >=
    0, by no more. Plus 1e-5 for f32 rounding. A window that lies wholly
    in the zero padding past the atlas edge has e = 0 and ratio 0."""
    rx, ry = A.fan_abl_positions(torch.tensor(geom), B, T, FAN5, 7)
    n, ox, oy = A.decode_tilemap(base["tatlas"], base["ttm"])
    tex = A.tile_bilinear(base["tatlas"], (n[..., None, None],
                                           ox[..., None, None],
                                           oy[..., None, None]), rx, ry)
    dev = tex - tex.mean(dim=-2, keepdim=True)
    norm = tex.square().sum(dim=(-2, -1)).sqrt()
    ratio = torch.where(norm == 0.0, torch.zeros_like(norm),
                        norm / dev.square().sum(dim=(-2, -1)).sqrt())
    return (2.0 ** -8 * (ratio + ratio[:, 0:1]) + 1e-5).numpy()


def _jax_k5(scripts, base, geom, mode):
    tiles = JF.build_tiles(jnp.asarray(base["atlas"]))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(scripts["ablate_fan"].incc_fan_abl(
            tiles, jnp.asarray(base["tilemap"]), jnp.asarray(geom), ppv=PPV,
            t=T, fan=FAN5, s2=S2, wsize=7, mode=mode))


@pytest.mark.parametrize("mode", A.FAN_ABL_MODES)
def test_incc_fan_abl_plain_matches_jax(scripts, base, k5_geom, mode):
    """Tolerances: full, the bf16 bound of `_bf16_incc_tol`; no_moments,
    2^-8 of the value (one sample, the same bf16 rounding) + 1e-5;
    wy_only and dma_only, exact to 1e-5 (no bf16-rounded operand)."""
    want = _jax_k5(scripts, base, k5_geom, mode)
    got = A.incc_fan_abl(base["tatlas"], base["ttm"],
                         torch.tensor(k5_geom), fan=FAN5, mode=mode).numpy()
    assert got.shape == want.shape == (B, T, FAN5)
    if mode == "full":
        tol = _bf16_incc_tol(base, k5_geom)
    elif mode == "no_moments":
        tol = 2.0 ** -8 * np.abs(want) + 1e-5
    else:
        tol = 1e-5
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    if mode != "dma_only":
        assert np.ptp(want) > 0.1


def test_incc_fan_abl_full_matches_v1_fan_plain(base, k5_geom):
    """K5 full equals the port's K3 plain version (ops/fan) on the same
    sample positions: the two sample alike and differ only in one-pass vs
    two-pass moments, which here costs < 1e-5 in f32 (|x| <= 255)."""
    got = A.incc_fan_abl(base["tatlas"], base["ttm"], torch.tensor(k5_geom),
                         fan=FAN5, mode="full")
    g = torch.tensor(k5_geom).reshape(4, B, T, FAN5, 4)
    n, ox, oy = A.decode_tilemap(base["tatlas"], base["ttm"])
    org = torch.stack([ox, oy], -1).to(torch.int32)
    line = g[0:2] + g[2:4]                                   # [2,B,T,F,4]
    frames = torch.stack([line[0, ..., 0] + ox[..., None],
                          line[1, ..., 0] + oy[..., None],
                          line[0, ..., 1], line[1, ..., 1],
                          line[0, ..., 2], line[1, ..., 2]], -1)
    ok = torch.ones((B, T, FAN5), dtype=torch.bool)
    want = incc_fan_v1_plain(base["tatlas"], n.to(torch.int32), org,
                             frames.float(), ok, 7)
    assert float((got - want).abs().max()) <= 1e-5


# ---- K6 -------------------------------------------------------------------

FAN6 = 4


@pytest.fixture(scope="module")
def k6_rel():
    """rel in the JAX layout [2, B*T*fan*s2L] (pad lanes -1000) and the
    port's [2, B, T, fan, S2]: x, y multiples of 1/64 in [-2, 34), so
    some taps leave the tile."""
    s2l = JF2.s2pl(S2, FAN6)
    lanes = B * T * FAN6 * s2l
    rel = np.full((2, lanes), -1000.0, np.float32)
    live = np.arange(lanes) % s2l < S2
    rel[:, live] = _q64(np.random.default_rng(6).uniform(
        -2.0, 34.0, (2, int(live.sum()))))
    port = rel.reshape(2, B, T, FAN6, s2l)[..., :S2]
    return rel, torch.tensor(np.ascontiguousarray(port))


def _jax_k6(scripts, base, rel, mode):
    """JAX K6 in the port's layout [8, B, T, fan, S2]. Scratch starts at
    zero: in wy_only the TPU kernel's fold also reads the scratch rows it
    never wrote (times 0), which the interpreter's default NaN fill would
    turn into NaN in row 0 too."""
    tiles2 = JF2.build_tiles2(jnp.asarray(base["atlas"]))
    params = pltpu.InterpretParams(uninitialized_memory="zero")
    with pltpu.force_tpu_interpret_mode(params):
        out = np.asarray(scripts["ablate_fan2"].call_abl(
            tiles2, jnp.asarray(base["tilemap"]), jnp.asarray(rel), ppv=PPV,
            fan=FAN6, mode=mode))
    s2l = JF2.s2pl(S2, FAN6)
    out = out.reshape(B // PPV, 8, PPV, T, FAN6, s2l).transpose(
        1, 0, 2, 3, 4, 5)
    return out.reshape(8, B, T, FAN6, s2l)[..., :S2]


@pytest.mark.parametrize("mode", A.INTERP_ABL_MODES)
def test_interp_abl_plain_matches_jax(scripts, base, k6_rel, mode):
    """Defined entries only (wy_only: row 0; dma_only: none, the TPU
    kernel writes uninitialised scratch), 1e-4 relative + 1e-5."""
    rel, trel = k6_rel
    got = A.interp_abl(base["tatlas"], base["ttm"], trel, mode=mode).numpy()
    rows = A.interp_abl_rows(mode)
    assert got.shape == (rows, B, T, FAN6, S2)
    if mode == "dma_only":
        assert not got.any()
        return
    want = _jax_k6(scripts, base, rel, mode)[:rows]
    if mode == "wy_only":
        got, want = got[:1], want[:1]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.ptp(want) > 0.1


def test_interp_abl_tiny_output_is_the_groups_first_windows(base, k6_rel):
    _, trel = k6_rel
    full = A.interp_abl(base["tatlas"], base["ttm"], trel, mode="full")
    tiny = A.interp_abl(base["tatlas"], base["ttm"], trel, mode="full",
                        tiny=True)
    assert tiny.shape == (3, B // PPV, 2, S2)
    want = full.reshape(3, B, T * FAN6, S2)[:, ::PPV, :2]
    assert torch.equal(tiny, want)


# ---- K7 -------------------------------------------------------------------

def _k7_frames(fan):
    """frames in the JAX layout [8, B*T*fan] and the port's [B, T, fan,
    6]: origin in [4, 26), steps 1 +- 0.25 px and shears +-0.25 px, all
    multiples of 1/64."""
    rng = np.random.default_rng(7 + fan)
    p = B * T * fan
    fr = np.zeros((8, p), np.float32)
    fr[0:2] = _q64(rng.uniform(4.0, 26.0, (2, p)))
    fr[2] = fr[5] = rng.choice([0.75, 1.0, 1.25], p)
    fr[3] = fr[4] = rng.choice([-0.25, 0.0, 0.25], p)
    port = fr[:6].reshape(6, B, T, fan).transpose(1, 2, 3, 0)
    return fr, torch.tensor(np.ascontiguousarray(port))


@pytest.mark.parametrize("fan", [4, 1])
@pytest.mark.parametrize("mode", A.MOMENTS_ABL_MODES)
def test_moments_abl_plain_matches_jax(scripts, base, mode, fan):
    """Moments (full, no_expand): rows 0-8, the (pair, probe) columns;
    no_moments, body_only: the first 128 lanes less their pad lanes.
    1e-4 relative + 1e-4 (f32 summation order of 49-sample sums)."""
    fr, tfr = _k7_frames(fan)
    tiles2 = JF2.build_tiles2(jnp.asarray(base["atlas"]))
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(scripts["ablate_fan25"].call_abl(
            tiles2, jnp.asarray(base["tilemap"]), jnp.asarray(fr), ppv=PPV,
            fan=fan, mode=mode))
    got = A.moments_abl(base["tatlas"], base["ttm"], tfr, mode=mode,
                        ppv=PPV).numpy()
    if mode in ("full", "no_expand"):
        want = out[:, :9, :PPV * T * fan].reshape(
            B // PPV, 9, PPV, T, fan).transpose(0, 2, 3, 4, 1)
        want = want.reshape(B, T, fan, 9)
        assert not out[:, 9:].any()
    else:
        lead = A.moments_abl_lead(fan)
        s2l = 128 // lead
        want = out[:, 0, :].reshape(B // PPV, lead, s2l)
        assert not want[..., S2:].any()
        want = want[..., :S2]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.ptp(want) > 0.1


# ---- wrappers and drivers -------------------------------------------------

def test_wrappers_run_plain_on_cpu(base, k5_geom, k6_rel):
    counts = (A.incc_fan_abl.launches, A.interp_abl.launches,
              A.moments_abl.launches)
    g = torch.tensor(k5_geom)
    assert torch.equal(
        A.incc_fan_abl(base["tatlas"], base["ttm"], g, fan=FAN5,
                       mode="no_moments"),
        A.incc_fan_abl_plain(base["tatlas"], base["ttm"], g, fan=FAN5,
                             mode="no_moments"))
    with pytest.raises(ValueError):
        A.interp_abl(base["tatlas"], base["ttm"], k6_rel[1], mode="no_y")
    assert counts == (A.incc_fan_abl.launches, A.interp_abl.launches,
                      A.moments_abl.launches)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("driver", [D5, D6, D7])
def test_driver_requires_cuda(no_cuda, driver):
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main([])


def _jax_driver_draws(batch):
    """The first draws of the JAX drivers' main() (scripts/ablate_fan.py:
    193-203, ablate_fan2.py:131-139, ablate_fan25.py:174-182), at
    `batch` patches."""
    rng = np.random.default_rng(0)
    atlas = np.asarray(jnp.asarray(rng.integers(
        0, 255, (AC.N, AC.H, AC.WA, 3), dtype=np.uint8)))
    ty, tx = JF.tile_counts(AC.H, AC.WA)
    v = rng.integers(0, AC.N, batch * AC.T)
    tyi = rng.integers(0, ty, batch * AC.T)
    txi = rng.integers(0, tx, batch * AC.T)
    tilemap = np.asarray(jnp.asarray((v << 20) | (tyi << 10) | txi,
                                     jnp.int32))
    return rng, atlas, tilemap, (v, tyi, txi)


@pytest.mark.parametrize("driver", [D5, D6, D7])
def test_driver_inputs_equal_the_jax_drivers(driver, scripts):
    """Each driver's inputs are the JAX driver's arrays, bit for bit, in
    the port's layout (at 64 patches; the draws are the same code at
    any batch)."""
    batch = 64
    mod = scripts[driver.__name__.rsplit(".", 1)[1]]
    if driver is not D5:          # ablate_fan.py keeps its shape in main()
        assert (mod.N, mod.H, mod.WA, mod.B, mod.WSIZE) == (
            AC.N, AC.H, AC.WA, AC.B, AC.WSIZE)
    got = driver.make_inputs(batch)
    rng, atlas, tilemap, (v, tyi, txi) = _jax_driver_draws(batch)
    np.testing.assert_array_equal(got["atlas"], atlas)
    np.testing.assert_array_equal(got["tilemap"].reshape(-1), tilemap)
    p = batch * AC.T
    if driver is D5:
        fan = D5.FAN
        geom = np.zeros((4, p * fan * 4), np.float32)
        geom[0, 0::4] = 14.0
        geom[1, 0::4] = 14.0
        geom[2, 0::4] = rng.uniform(0, 1, p * fan)
        geom[3, 0::4] = 0.25
        geom[0, 1::4] = 1.0
        geom[1, 2::4] = 1.0
        np.testing.assert_array_equal(got["geom"], np.asarray(
            jnp.asarray(geom)))
        order = np.lexsort((txi, tyi, v))
        np.testing.assert_array_equal(
            got["tilemap_sorted"].reshape(-1),
            np.asarray(jnp.asarray(((v << 20) | (tyi << 10) | txi)[order],
                                   jnp.int32)))
    elif driver is D6:
        s2l = JF2.s2pl(AC.S2, D6.FAN)
        lanes = p * D6.FAN * s2l
        rel = np.full((2, lanes), -1000.0, np.float32)
        live = np.arange(lanes) % s2l < AC.S2
        rel[:, live] = rng.uniform(4.0, 26.0, (2, int(live.sum())))
        np.testing.assert_array_equal(
            got["rel"], rel.reshape(2, batch, AC.T, D6.FAN, s2l)[..., :AC.S2])
    else:
        for fan in D7.FANS:
            frames = np.zeros((8, p * fan), np.float32)
            frames[0:2] = rng.uniform(8.0, 20.0, (2, p * fan))
            frames[2] = 1.0
            frames[5] = 1.0
            np.testing.assert_array_equal(
                got[f"frames{fan}"],
                frames[:6].reshape(6, batch, AC.T, fan).transpose(1, 2, 3, 0))

"""The block-window wrappers' contract on the CPU (no kernel is launched
here).

The window and view limits that K2 and K4 (csrc/common.cuh) take, the
compulsory bytes that `chip_smoke.call_bound` counts for them against a
hand count, and the wrappers on CPU tensors returning the plain versions,
uncounted and uncaptured.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cmvs_pmvs_tpu_torch.ops import incc  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import windows as W  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.texture import BLOCK_K  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "cmvs_pmvs_tpu_torch" / "csrc" / "common.cuh"
MAX_S2 = W.MAX_WSIZE ** 2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_block_window_limit_matches_kernel_source():
    src = CSRC.read_text()
    assert int(re.search(r"kBlockMaxWsize = (\d+);", src).group(1)) \
        == W.MAX_WSIZE


@pytest.mark.parametrize("pairs,t,s2,k,max_t", [
    (12, 0, 49, BLOCK_K, None),       # no views
    (66, 33, 49, BLOCK_K, 32),        # K4 takes at most 32 views
    (13, 6, 49, BLOCK_K, None),       # not a whole number of patches
    (12, 6, 0, BLOCK_K, None),        # empty window
    (12, 6, MAX_S2 + 1, BLOCK_K, 32),  # past wsize 63
    (12, 6, 49, 0, None),             # empty block
])
def test_block_shape_check_rejects(pairs, t, s2, k, max_t):
    with pytest.raises(ValueError):
        W.check_block_shape("windows", pairs, t, s2, k, max_t)


@pytest.mark.parametrize("pairs,t,s2,k,max_t", [
    (12, 12, 49, BLOCK_K, None),
    (64, 64, 49, BLOCK_K, None),      # K2 takes any T
    (64, 32, MAX_S2, 1, 32),
    (7, 1, 1, BLOCK_K, 32),
    (0, 6, 121, BLOCK_K, 32),         # an empty batch launches nothing
])
def test_block_shape_check_accepts(pairs, t, s2, k, max_t):
    W.check_block_shape("incc_blocks", pairs, t, s2, k, max_t)


B, T, S2 = 3, 4, 9


def _case(seed=0):
    """A tiny K2/K4 batch: random atlas, block starts (two past the
    atlas's edges, clamped), positions reaching 1.5 px past the block,
    some pairs failed, and patch 1's reference failed beside an ok
    view."""
    rng = np.random.default_rng(seed)
    n, h, wa = 2, 30, 40
    atlas = torch.tensor(rng.integers(0, 256, (n, h, wa, 3), np.uint8))
    bt = B * T
    starts = np.stack([rng.integers(0, n, bt), rng.integers(0, h - BLOCK_K,
                                                            bt),
                       rng.integers(0, wa - BLOCK_K, bt)], -1)
    starts[2] = (1, -4, wa + 3)
    starts[5] = (1, h, wa + 3)
    rel = rng.uniform(-1.5, BLOCK_K + 0.5, (2, bt, S2))
    ok = rng.random(bt) > 0.3
    ok[[0, 2, 5]] = True
    ok[[1, 4]] = False
    return (atlas, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(rel[0], dtype=torch.float32),
            torch.tensor(rel[1], dtype=torch.float32), torch.tensor(ok))


def _hand_bytes(name, atlas, starts, relx, rely, ok, blocked=True):
    """Compulsory bytes by hand: starts (12 B), ok (1 B) and the output
    of every pair; relx/rely (8 B a sample) and the distinct pixels (3 B
    on a uint8 atlas, 12 B on a float32 one) of the taps of each window
    the output needs: blocked, the in-block taps of the clamped block;
    unblocked, every tap from the start as given, clamped into the
    atlas."""
    n_, h, wa, _ = atlas.shape
    ok = ok.numpy()
    need = ok if name == "windows" else \
        ok & np.repeat(ok.reshape(B, T)[:, 0], T)
    pixels = set()
    for p in np.flatnonzero(need):
        n = min(max(int(starts[p, 0]), 0), n_ - 1)
        sy, sx = int(starts[p, 1]), int(starts[p, 2])
        if blocked:
            sy = min(max(sy, 0), h - BLOCK_K)
            sx = min(max(sx, 0), wa - BLOCK_K)
        for rx, ry in zip(relx[p].tolist(), rely[p].tolist()):
            for dx in (0, 1):
                for dy in (0, 1):
                    lx, ly = int(np.floor(rx)) + dx, int(np.floor(ry)) + dy
                    if not blocked or (0 <= lx < BLOCK_K
                                       and 0 <= ly < BLOCK_K):
                        pixels.add((n, min(max(sy + ly, 0), h - 1),
                                    min(max(sx + lx, 0), wa - 1)))
    out = B * T * (S2 * 3 * 4 if name == "windows" else 4)
    return (B * T * 13 + out + int(need.sum()) * S2 * 8
            + 3 * atlas.element_size() * len(pixels))


@pytest.mark.parametrize("name", ["windows", "incc_blocks"])
def test_call_bound_counts_only_needed_windows(name):
    cs = _chip_smoke()
    args = _case()
    ok = args[4]
    got = cs.call_bound(name, args, {"t": T})
    want = _hand_bytes(name, *args)
    assert got["bytes"] == want
    # the earlier count: every pair's positions (and the taps of ok pairs)
    assert got["old_bytes"] == _hand_bytes("windows", *args) \
        + (B * T * 4 - B * T * S2 * 12 if name == "incc_blocks" else 0) \
        + int((~ok).sum()) * S2 * 8
    assert got["old_bytes"] > got["bytes"]
    assert got["bound_ms"] == pytest.approx(
        max(want / cs.HBM_BYTES_PER_S,
            got["flops"] / cs.FP32_FLOP_PER_S) * 1e3)


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("name", ["windows", "incc_blocks"])
def test_call_bound_counts_element_size_and_rule(name, dtype, blocked):
    """The float32 (gamma) and unblocked instantiations' bytes: 12 B a
    distinct float pixel, and every tap of an unblocked window (from its
    start as given) where the blocked rule counts the in-block ones."""
    cs = _chip_smoke()
    atlas, *rest = _case(2)
    if dtype == torch.float32:
        atlas = (atlas.float() / 255.0) ** 2.2
    args = (atlas, *rest)
    inst = (name + ("" if blocked else "_unblocked")
            + ("_f32" if dtype == torch.float32 else ""))
    got = cs.call_bound(inst, args, {"t": T, "blocked": blocked})
    assert got["bytes"] == _hand_bytes(name, *args, blocked=blocked)
    assert got["flops"] == cs.call_bound(name, args, {"t": T})["flops"]
    if dtype == torch.float32:
        u8 = cs.call_bound(name, (_case(2)[0], *rest),
                           {"t": T, "blocked": blocked})
        assert got["bytes"] > u8["bytes"]


def test_fan_atlas_bytes_count_the_element_size():
    """A float32 atlas's taps cost 12 B a pixel, four times a uint8
    atlas's 3 B, on the same inputs (chip_smoke.fan_atlas_bytes, and
    call_bound for K1 and K3 through it)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(4)
    u8 = torch.tensor(rng.integers(0, 256, (2, 40, 50, 3), np.uint8))
    f32 = u8.float() / 255.0
    vid = torch.tensor(rng.integers(0, 2, (3, 4)), dtype=torch.int32)
    frames = torch.tensor(np.concatenate(
        [rng.uniform(5, 30, (3, 4, 2, 2)), rng.uniform(0.8, 1.2,
                                                       (3, 4, 2, 4))], -1),
        dtype=torch.float32)
    ok = torch.tensor(rng.random((3, 4, 2)) > 0.2)
    org = torch.zeros((3, 4, 2), dtype=torch.int32)
    for tile in (None, org):
        a = cs.fan_atlas_bytes(u8, vid, frames, ok, tile)
        assert a > 0 and cs.fan_atlas_bytes(f32, vid, frames, ok,
                                            tile) == 4 * a
    b8 = cs.call_bound("incc_fan", (u8, vid, frames, ok, 7), {})
    b32 = cs.call_bound("incc_fan_f32", (f32, vid, frames, ok, 7), {})
    assert b32["bytes"] - b8["bytes"] == 3 * cs.fan_atlas_bytes(
        u8, vid, frames, ok)
    assert b32["flops"] == b8["flops"]


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__286623da_10_windows\
_cu_7fad12e814windows_kernelILi2EEEvPKhiiiPKiPKfS6_S2_Pfxii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__286623da_10_windows\
_cu_7fad12e814windows_kernelILi2EEEvPKhiiiPKiPKfS6_S2_Pfxii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN4cmvs15fan_incc_kernelILi0ELb1EEEv\
PKhiiiPKiS3_PKfS2_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN4cmvs15fan_incc_kernelILi0ELb1EEEv\
PKhiiiPKiS3_PKfS2_Pfiiii
    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 16 bytes cumulative stack
"""


def test_kernel_registers_parses_ptxas_report():
    """chip_smoke reads each kernel's registers and spills off the
    build's `-Xptxas -v` output; a pixel type argument reads u8 or f32."""
    assert _chip_smoke().kernel_registers(PTXAS) == [
        ("windows_kernel<2>", 32, 0), ("fan_incc_kernel<0, 1>", 64, 16)]
    typed = PTXAS.replace("windows_kernelILi2EEE", "windows_kernelILi2ELb0EfEE"
                          ).replace("fan_incc_kernelILi0ELb1EEE",
                                    "fan_incc_kernelILi0ELb1EhEE")
    assert _chip_smoke().kernel_registers(typed) == [
        ("windows_kernel<2, 0, f32>", 32, 0),
        ("fan_incc_kernel<0, 1, u8>", 64, 16)]


def test_wrappers_on_cpu_return_plain_uncounted():
    args = _case(1)
    wrappers = [*W.windows.entries.values(),
                *incc.incc_blocks.entries.values()]
    before = [w.launches for w in wrappers]
    try:
        for w in wrappers:
            w.capture = []
        got = W.windows(*args, t=T)
        got4 = incc.incc_blocks(*args, t=T)
        assert all(w.capture == [] for w in wrappers)
    finally:
        for w in wrappers:
            w.capture = None
    assert [w.launches for w in wrappers] == before
    assert torch.equal(got, W.windows_plain(*args, t=T))
    assert torch.equal(got4, incc.incc_blocks_plain(*args, t=T))
    assert bool((got4 == 2.0).any())

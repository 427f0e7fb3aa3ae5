"""The fan wrappers' contract on the CPU (no kernel is launched here).

The window and view limits that K1 and K3 (csrc/common.cuh) take, the
opt-in launch capture, and the v1 tile rule's plain version agreeing
bit for bit with K1's where no tap leaves the tile (chip_smoke.py phase
6 reads the same property off the kernels).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cmvs_pmvs_tpu_torch.ops import fan as F1, fan2, kernels  # noqa: E402
# imported for the K2/K4 Entries they add to kernels.ENTRIES
from cmvs_pmvs_tpu_torch.ops import incc, windows  # noqa: E402,F401

CSRC = Path(F1.__file__).resolve().parents[1] / "csrc" / "common.cuh"


def test_fan_window_limit_matches_kernel_source():
    src = CSRC.read_text()
    assert int(re.search(r"kFanMaxWsize = (\d+);", src).group(1)) \
        == F1.MAX_WSIZE


@pytest.mark.parametrize("t,wsize", [(0, 7), (33, 7), (6, 0),
                                     (6, F1.MAX_WSIZE + 1)])
def test_fan_shape_check_rejects(t, wsize):
    with pytest.raises(ValueError):
        F1.check_fan_shape("incc_fan", t, wsize)


@pytest.mark.parametrize("t,wsize", [(1, 1), (6, 7), (32, F1.MAX_WSIZE)])
def test_fan_shape_check_accepts(t, wsize):
    F1.check_fan_shape("incc_fan", t, wsize)


def _inside_tile_case(seed, b=6, t=4, fan=2):
    """Random atlas and windows (wsize 7, steps ~1 px) that stay 2+ px
    inside their pair's tile."""
    rng = np.random.default_rng(seed)
    atlas = torch.tensor(rng.integers(0, 256, (3, 64, 80, 3), np.uint8))
    vid = torch.tensor(rng.integers(0, 3, (b, t)), dtype=torch.int32)
    fr = np.empty((b, t, fan, 6))
    fr[..., 0:2] = rng.uniform(20.0, 40.0, (b, t, fan, 2))
    fr[..., 2] = rng.uniform(0.9, 1.1, (b, t, fan))
    fr[..., 3] = rng.uniform(-0.1, 0.1, (b, t, fan))
    fr[..., 4] = rng.uniform(-0.1, 0.1, (b, t, fan))
    fr[..., 5] = rng.uniform(0.9, 1.1, (b, t, fan))
    fr[..., 1:, 0:2] = fr[..., :1, 0:2] + rng.uniform(-1.0, 1.0,
                                                      (b, t, fan - 1, 2))
    org = np.floor((fr[:, :, 0, 0:2] - 8.0) / 12.0) * 12.0
    ok = rng.random((b, t, fan)) > 0.1
    return (atlas, vid, torch.tensor(org, dtype=torch.int32),
            torch.tensor(fr, dtype=torch.float32), torch.tensor(ok))


@pytest.mark.parametrize("seed", [0, 1])
def test_v1_plain_equals_v2_plain_inside_the_tile(seed):
    atlas, vid, org, frames, ok = _inside_tile_case(seed)
    stats = {}
    F1.count_clipped(stats, org, frames, ok, 7)
    assert int(stats["clipped"]) == 0 and int(stats["probes"]) > 0
    v1 = F1.incc_fan_v1_plain(atlas, vid, org, frames, ok, 7)
    v2 = fan2.incc_fan_plain(atlas, vid, frames, ok, 7)
    assert torch.equal(v1, v2)


def test_capture_is_off_and_keeps_no_cpu_call():
    """The capture lists are None by default, and a CPU call (the plain
    version) is neither counted nor kept."""
    wrappers = list(kernels.ENTRIES.values())
    assert len(wrappers) == 12
    assert all(w.capture is None for w in wrappers)
    atlas, vid, org, frames, ok = _inside_tile_case(2)
    before = [w.launches for w in wrappers]
    try:
        for w in wrappers:
            w.capture = []
        got = fan2.incc_fan(atlas, vid, frames, ok, 7)
        got_v1 = F1.incc_fan_v1(atlas, vid, org, frames, ok, 7)
        assert all(w.capture == [] for w in wrappers)
    finally:
        for w in wrappers:
            w.capture = None
    assert [w.launches for w in wrappers] == before
    assert torch.equal(got, fan2.incc_fan_plain(atlas, vid, frames, ok, 7))
    assert torch.equal(got_v1, F1.incc_fan_v1_plain(atlas, vid, org,
                                                    frames, ok, 7))

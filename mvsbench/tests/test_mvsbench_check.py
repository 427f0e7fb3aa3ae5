"""The check on the CPU at a tiny size: a sound run is correct; the
lower-precision control reads above the limits; and with the program
broken underneath, each fault the cells can have turns `correct` false.

Each test drives `run.run_cell` (the harness's look for a card left out,
device="cpu") on a copy of the benchmark with the cell `tiny.l0` added:
5 views of 96x72, set-up's two cold reconstructions and one in the
window (`seconds` 0), at p_cap 4096, 2 rounds of at most 4 waves (the
tiny traffic's `reconstruct` arguments): ~1 min a run."""
import json

import pytest
import torch

from mvsbench import check, control, faults, run

from conftest import TINY, add_tiny_cell

SEED = 2**31 + 77


@pytest.fixture
def tiny(bench_copy):
    add_tiny_cell(bench_copy)
    return bench_copy


def go(root, faults=None):
    return run.run_cell(root, TINY, SEED, 0.0, False, device="cpu",
                        faults=faults)


def test_sound_run_is_correct(tiny):
    res = go(tiny)
    assert res["correct"], json.dumps(res["compared"])
    assert res["attempted"] == 1 and res["failed"] == 0
    assert list(res["compared"])[-1] == "cover_miss"
    assert list(res)[-1] == "compared"
    # the one-card result line keeps its keys through the shared loop
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "diagnostics", "compared"]
    assert list(res["metrics"]) == ["recon_s", "setup_s"]
    assert list(res["device"]) == ["platform", "kind", "count",
                                   "memory_peak_bytes"]
    assert list(res["diagnostics"]) == ["window_s", "cold_recon_s",
                                        "phase_s", "patches"]
    assert res["metrics"]["recon_s"]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0


def test_control_reads_above_the_limits(tiny):
    limits = json.load(open(f"{tiny}/mvsbench/limits/{TINY}.json"))
    [(seed, prog, ctrl)] = list(control.readings(tiny, TINY, [SEED],
                                                 device="cpu"))
    assert check.verdict([prog], limits)[0]
    assert not check.verdict([ctrl], limits)[0]
    assert prog["pyramid_gap"] <= limits["pyramid_gap"]
    assert prog["color_miss"] <= limits["color_miss"]
    assert prog["ncc_gap"] <= limits["ncc_gap"]
    assert ctrl["pyramid_gap"] > limits["pyramid_gap"]
    assert ctrl["color_miss"] > 3 * max(prog["color_miss"], 1e-3)
    assert ctrl["color_miss"] > limits["color_miss"]
    assert ctrl["ncc_gap"] > 3 * limits["ncc_gap"]


@pytest.mark.parametrize("fault,number", [
    (faults.unchanged, "cover_miss"), (faults.half_written, "file_miss"),
    (faults.moved, "ncc_gap"), (faults.pixel, "pyramid_gap")],
    ids=["state_unchanged", "half_left_out", "answer_moved",
         "pixel_altered"])
def test_fault_is_not_correct(tiny, fault, number):
    res = go(tiny, fault)
    assert not res["correct"]
    c = res["compared"][number]
    assert c["value"] > c["limit"], json.dumps(res["compared"])


def test_reference_does_not_use_tf32():
    assert not torch.backends.cuda.matmul.allow_tf32

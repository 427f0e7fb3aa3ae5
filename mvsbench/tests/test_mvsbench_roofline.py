"""The copied roofline arithmetic (mvsbench/roofline.py) against the
values the repository's chip_smoke.bound / call_bound give on the same
fixed inputs (recorded here: nothing under mvsbench imports
chip_smoke), and the copied functions' code against chip_smoke's."""
import ast
import os

import numpy as np
import pytest
import torch

from mvsbench import roofline as R

from conftest import REPO


def inputs():
    rng = np.random.default_rng(7)
    atlas = torch.as_tensor(rng.integers(0, 256, (3, 40, 90, 3),
                                         dtype=np.uint8))
    b, t, fan = 6, 4, 2
    vid = torch.as_tensor(rng.integers(0, 3, (b, t)), dtype=torch.int32)
    frames = torch.as_tensor(np.concatenate(
        [rng.uniform(5, 30, (b, t, fan, 2)),
         rng.uniform(-1.2, 1.2, (b, t, fan, 4))], -1), dtype=torch.float32)
    ok = torch.as_tensor(rng.uniform(size=(b, t, fan)) > 0.3)
    bt, s2 = 12, 49
    starts = torch.as_tensor(np.stack(
        [rng.integers(0, 3, bt), rng.integers(-2, 30, bt),
         rng.integers(-2, 80, bt)], 1), dtype=torch.int32)
    relx = torch.as_tensor(rng.uniform(-1.5, 20.5, (bt, s2)),
                           dtype=torch.float32)
    rely = torch.as_tensor(rng.uniform(-1.5, 20.5, (bt, s2)),
                           dtype=torch.float32)
    okb = torch.as_tensor(rng.uniform(size=bt) > 0.25)
    return atlas, (vid, frames, ok), (starts, relx, rely, okb)


# chip_smoke.call_bound / bound on inputs() (bound_ms, bound_by, bytes,
# flops)
WANT = {
    "incc_fan": (2.2115820895522387e-06, "operations", 4605, 148176),
    "windows": (3.525671641791045e-06, "bytes", 11811, 13524),
    "windows_unblocked": (3.6850746268656716e-06, "bytes", 12345, 13524),
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_call_bound_equals_chip_smoke(name):
    atlas, k1, k2 = inputs()
    args, kw = {"incc_fan": ((atlas, *k1, 7), {}),
                "windows": ((atlas, *k2), {"t": 3}),
                "windows_unblocked": ((atlas, *k2),
                                      {"t": 4, "blocked": False})}[name]
    got = R.call_bound(name, args, kw)
    assert (got["bound_ms"], got["bound_by"], got["bytes"],
            got["flops"]) == WANT[name]


def test_bound_equals_chip_smoke():
    assert R.bound("incc_blocks_f32", 12345, 6789012) == {
        "bound_ms": 0.002026570746268657, "bound_by": "bytes",
        "bytes": 6789012, "flops": 641940}


def test_counter_adds_the_launches():
    atlas, k1, _ = inputs()
    c = R.Counter("incc_fan")
    for _ in range(3):
        c.append(((atlas, *k1, 7), {}))
    assert c.calls == 3 and c.flops == 3 * WANT["incc_fan"][3]
    assert c.bound_ms == pytest.approx(3 * WANT["incc_fan"][0])
    assert c.bound_by() == "operations"


def _defs(path):
    tree = ast.parse(open(path).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                body = body[1:]     # the docstring
            # chip_smoke imports inside each function; the copy at the top
            body = [b for b in body
                    if not isinstance(b, (ast.Import, ast.ImportFrom))]
            out[node.name] = ast.dump(ast.Module(body=body,
                                                 type_ignores=[]))
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node.value)
    return out


@pytest.mark.parametrize("name", [
    "bound", "nbytes", "atlas_bytes", "base_name", "fan_taps",
    "fan_atlas_bytes",
    "block_atlas_bytes", "block_need", "block_bytes", "HBM_BYTES_PER_S",
    "FP32_FLOP_PER_S"])
def test_copied_code_is_chip_smokes(name):
    mine = _defs(os.path.join(REPO, "mvsbench", "roofline.py"))
    theirs = _defs(os.path.join(REPO, "chip_smoke.py"))
    assert mine[name] == theirs[name]


def test_flops_per_sample_are_chip_smokes():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    tree = ast.parse(src)
    theirs = next(ast.literal_eval(n.value) for n in tree.body
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", "") == "FLOPS_PER_SAMPLE")
    for k, v in R.FLOPS_PER_SAMPLE.items():
        assert theirs[k] == v


def test_sample_lattice_is_the_ports():
    mine = _defs(os.path.join(REPO, "mvsbench", "roofline.py"))
    theirs = _defs(os.path.join(REPO, "cmvs_pmvs_tpu_torch", "ops",
                                "fan.py"))
    assert mine["window_positions"] == theirs["window_positions"]

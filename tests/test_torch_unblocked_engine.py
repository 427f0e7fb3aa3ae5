"""The port's engine against the JAX engine with unblocked bilinear
grabs (texture._USE_BLOCK_SAMPLING = False: the reference package's
`bilinear_color` route), through test_torch_variants_engine.py's runner
and test_torch_pipeline.py's bars (patch counts within 10%, both medians
of plane distance / dscale < 0.3 and within 0.05).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_variants_engine import check_run, run_both  # noqa: E402


@pytest.fixture(scope="module")
def unblocked(tmp_path_factory):
    return run_both(tmp_path_factory, "unblocked")


def test_unblocked_meets_pipeline_bars(unblocked):
    """Every plain window sampled the uint8 atlas without the block
    rule."""
    check_run("unblocked", *unblocked, ("uint8", False))

"""The port's engine in the photographic regime.

Counterpart of tests/test_textured.py, on the port's CPU path: the
textured scene (utils/synthetic.make_textured_scene: multi-octave noise
albedo, a textureless disk that exercises setEdge, reference
image.cpp:407-471, a view-dependent specular lobe, per-view gain/bias
jitter and sensor noise) with the same options, run and bars. The JAX
test's keep-ratio check reads an `eng.filter_stats` that neither engine
has; here it reads the last round's (before, after) counts from
`eng.stats[-1]`, with the JAX test's bar.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu_torch.models.engine import reconstruct  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import (  # noqa: E402
    make_textured_scene, write_pmvs_tree)

PASSES = ("outside", "exact", "neighbor", "groups")


@pytest.fixture(scope="module")
def recon(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("textured"))
    scene = make_textured_scene(num_cameras=8, width=160, height=120,
                                focal=220.0)
    write_pmvs_tree(scene, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0.4\nuseBound 0\nuseVisData 0\n"
                "sequence -1\ntimages -1 0 8\noimages 0\n")
    eng = reconstruct(root, "option.txt", p_cap=12000, expand_iters=1,
                      max_waves=2, refine_iters=8, log=lambda *a: None,
                      device="cpu")
    alive = eng.cloud.alive.numpy()
    coord = eng.cloud.coord.numpy()[alive][:, :3]
    dscale = eng.cloud.dscale.numpy()[alive]
    return scene, eng, coord, dscale


def test_textured_accuracy(recon):
    """Reconstruction survives noise/jitter/specular with most patches
    on true surfaces."""
    scene, _, coord, dscale = recon
    assert len(coord) > 300, len(coord)
    d = scene.surface_distance(coord) / dscale
    print(f"[textured] patches {len(coord)} median {np.median(d):.4f} "
          f"q90 {np.quantile(d, 0.9):.4f}")
    assert np.median(d) < 0.5, np.median(d)


def test_textureless_region_suppressed(recon):
    """setEdge keeps the flat disk from sprouting patches: density
    inside the textureless region stays well below the scene's."""
    _, _, coord, _ = recon
    on_ground = np.abs(coord[:, 2]) < 0.05
    g = coord[on_ground]
    r2 = (g[:, 0] - 0.9) ** 2 + (g[:, 1] + 0.9) ** 2
    inside = (r2 < 0.22 ** 2).sum()          # clear of the rim
    ring = ((r2 > 0.4 ** 2) & (r2 < 0.62 ** 2)).sum()
    area_inside = np.pi * 0.22 ** 2
    area_ring = np.pi * (0.62 ** 2 - 0.4 ** 2)
    dens_in = inside / area_inside
    dens_ring = max(ring / area_ring, 1e-9)
    print(f"[textured] disk {inside} ring {ring}")
    assert dens_in < 0.5 * dens_ring, (inside, ring)


def test_keep_ratios_sensible(recon):
    """The filters trim outliers without destroying the cloud (the
    reference prints comparable keep-ratios per pass,
    filter.cpp:82-85, 287-291)."""
    _, eng, coord, _ = recon
    assert len(coord) > 300
    last = eng.stats[-1]
    print(f"[textured] stats {last}")
    assert all(k in last for k in PASSES), last
    for name in PASSES:
        before, after = last[name]
        if before > 0:
            assert after >= 0.3 * before, (name, before, after)

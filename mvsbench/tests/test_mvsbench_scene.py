"""The device generator (mvsbench/scene.py) against the port's
`utils/synthetic.make_occluded_scene` at a small size, and its ground
truth against the original's."""
import numpy as np
import pytest
import torch

from cmvs_pmvs_tpu_torch.utils.synthetic import make_occluded_scene
from mvsbench import scene as S


@pytest.mark.parametrize("seed", [42, 2**31 + 11])
def test_render_equals_the_original(seed):
    want = make_occluded_scene(num_cameras=5, width=96, height=72,
                               focal=105.0, seed=seed)
    got = S.render(5, 96, 72, 105.0, 1.6, 3.2, seed, "cpu")
    assert np.array_equal(got.P, want.P)
    assert np.array_equal(got.centers, want.centers)
    assert np.array_equal(got.images, want.images)
    assert np.array_equal(got.boxes, want.boxes)


def test_second_scene_has_other_textures_only():
    a = S.render(4, 64, 48, 70.0, 1.6, 3.2, 5, "cpu")
    b = S.render(4, 64, 48, 70.0, 1.6, 3.2, 5 + S.SECOND_TEXTURES, "cpu")
    assert np.array_equal(a.P, b.P)
    assert (a.images != b.images).mean() > 0.5


def test_surface_normal():
    n = S.surface_normal(S.BOXES, torch.tensor(
        [[0.3, -0.8, 0.01], [0.4, 0.1, 0.72], [-0.56, -0.2, 0.2],
         [0.0, 0.76, 0.1]], dtype=torch.float64))
    assert n.tolist() == [[0, 0, 1], [0, 0, 1], [-1, 0, 0], [0, 1, 0]]


def test_ray_depth_hits_the_rendered_surface():
    sc = S.render(3, 48, 36, 55.0, 1.6, 3.2, 1, "cpu")
    P, C, R, K = S.ring_cameras(3, 48, 36, 55.0, 1.6, 3.2)
    d = S.ray_directions(K, R, 48, 36, "cpu")
    Ct = torch.as_tensor(C)[:, None, None, :]
    t = S.ray_depth(S.BOXES, Ct, d)
    X = Ct + t[..., None] * d
    want = make_occluded_scene(num_cameras=3, width=32, height=24,
                               focal=40.0)
    assert want.surface_distance(X.reshape(-1, 3).numpy()).max() < 1e-9
    assert sc.images.shape == (3, 36, 48, 3)

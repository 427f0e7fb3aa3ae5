"""cmvs_pmvs_tpu_torch: the PMVS main path in PyTorch + CUDA.

A port of `cmvs_pmvs_tpu` (the JAX/Pallas reference package, which stays
untouched beside it) to PyTorch on an NVIDIA Hopper GPU. The layer map
mirrors the reference package so each module's counterpart is easy to
find:

  geom/    - batched cameras, epipolar geometry, triangulation
  image/   - mip-atlas pyramids + bilinear sampling
  ops/     - texture grabs, the two hand-written CUDA kernels (ops/fan2:
             the refine fan INCC, ops/windows: normalized texture
             windows), LM refinement, Harris/DoG detection
  models/  - the PMVS engine: seed, expand, filter, patch cloud, grid
  utils/   - tracing
  cli/     - the pmvs3 entry point

Jax-free modules of the reference package are shared by import, not
copied: `cmvs_pmvs_tpu.io.*`, `cmvs_pmvs_tpu.utils.options` and
`cmvs_pmvs_tpu.utils.synthetic`. This package never imports jax.

Precision: float32 matmuls and convolutions run in full float32 (no
TF32). The pyramid downsample is bit-exact against the reference and
Harris is held to 5e-4, neither of which survives TF32 rounding.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

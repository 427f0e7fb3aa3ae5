"""cmvs_pmvs_tpu_torch: CMVS + PMVS in PyTorch + CUDA.

A port of `cmvs_pmvs_tpu` (the JAX/Pallas reference package, which stays
untouched beside it) to PyTorch on an NVIDIA Hopper GPU. The layer map
mirrors the reference package so each module's counterpart is easy to
find:

  geom/    - batched cameras, epipolar geometry, triangulation
  image/   - mip-atlas pyramids + bilinear sampling
  ops/     - texture grabs, the hand-written CUDA kernels (ops/fan2 and
             ops/fan: the refine fan INCC, v2 and v1; ops/incc: the
             fused block INCC; ops/windows: normalized texture
             windows), LM refinement, Harris/DoG detection
  models/  - the PMVS engine: seed, expand, filter, patch cloud, grid;
             CMVS view clustering (cmvs.py) and genOption
  parallel/ - the cluster scheduler (one reconstruct per cluster) and
             the merge of the cluster clouds
  io/      - cameras, images, vis.dat, .patch/.pset/.ply, bundle.rd.out,
             ske.dat
  utils/   - options, synthetic scenes, tracing
  cli/     - the pmvs3, cmvs3, genOption and pmvs3_all entry points

The package imports neither jax nor anything of `cmvs_pmvs_tpu`: the
reference package's jax-free modules it needs (io/, utils/options.py,
utils/synthetic.py) are copied here, and tests/test_torch_imports.py
checks that no import reaches the reference package.

Precision: float32 matmuls and convolutions run in full float32 (no
TF32). The pyramid downsample is bit-exact against the reference and
Harris is held to 5e-4, neither of which survives TF32 rounding.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

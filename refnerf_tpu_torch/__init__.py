"""refnerf_tpu_torch: the PyTorch + CUDA port of refnerf_tpu for NVIDIA Hopper.

The JAX package `refnerf_tpu` stays the reference; every module here has a
counterpart of the same name there. The port serves and trains the Ref-NeRF
model:

  configs.py          Config fields the port reads, parsed with ginlite
  convert.py          flax parameter tree -> state_dict
  utils/ginlite.py    the gin parser
  ops/                mathx, stepfun, coord, geopoly, ref_utils, image;
                      fused_mlp (the trunk kernel wrappers and their plain
                      versions) and cuda_build (nvcc build of csrc/ at first
                      use)
  cameras/rays.py     Rays and Batch as dataclasses of tensors
  models/             MLP, Model (the cascade), render, construct, renderer
  train/              losses and the train step
  csrc/               the hand-written CUDA kernels (sm_90a)

Entry points: `models.construct.construct_model` (on the GPU unless the
caller names another device), `models.renderer.render_rays`,
`models.renderer.render_image` and `train.step.make_train_step`.
The package imports torch and neither jax nor anything of refnerf_tpu:
`utils/ginlite.py` and `ops/geopoly.py` are its own copies of the JAX
package's modules of those names.
"""

__version__ = '0.1.0'

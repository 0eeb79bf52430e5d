"""refnerf_tpu_torch: the PyTorch + CUDA port of refnerf_tpu for NVIDIA Hopper.

The JAX package `refnerf_tpu` stays the reference; every module here has a
counterpart of the same name there. The port trains, serves and evaluates
the Ref-NeRF and mip-NeRF models:

  configs.py          Config fields the port reads, parsed with ginlite
  convert.py          flax parameter tree -> state_dict
  metrics.py          PSNR, SSIM, LPIPS (from a weights file), eval_metrics
  utils/ginlite.py    the gin parser
  utils/io.py         image IO: the port's own PNG codec, Pillow otherwise
  ops/                mathx, stepfun, coord, geopoly, ref_utils, image;
                      fused_mlp (the trunk kernel wrappers and their plain
                      versions) and cuda_build (nvcc build of csrc/ at first
                      use)
  cameras/            Rays, Pixels and Batch as dataclasses of tensors; the
                      pose math, render paths and ray casts (camera_utils)
  data/               the scene loaders (datasets, colmap) and the
                      host-to-device pipeline (prefetch)
  models/             MLP, Model (the cascade), render, construct, renderer
  train/              losses and the train step
  tools/              the A/B and phase-timing tools of the kernels; the
                      analytic sphere scene
  csrc/               the hand-written CUDA kernels (sm_90a)

Entry points: `models.construct.construct_model` (on the GPU unless the
caller names another device), `models.renderer.render_rays`,
`models.renderer.render_image`, `data.datasets.load_dataset`,
`data.prefetch.training_batches` (to the GPU unless told otherwise) and
`train.step.make_train_step`. The package imports torch, numpy and scipy,
and neither jax nor anything of refnerf_tpu: `utils/ginlite.py` and
`ops/geopoly.py` are its own copies of the JAX package's modules of those
names.
"""

__version__ = '0.1.0'

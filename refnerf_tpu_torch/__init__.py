"""refnerf_tpu_torch: the PyTorch + CUDA port of refnerf_tpu for NVIDIA Hopper.

The JAX package `refnerf_tpu` stays the reference; every module here has a
counterpart of the same name there. This first slice is the serving forward
of the Ref-NeRF model:

  configs.py          Config fields the port reads, parsed with ginlite
  convert.py          flax parameter tree -> state_dict
  ops/                mathx, stepfun, coord, ref_utils, image; fused_mlp (the
                      trunk kernel wrappers and their plain versions) and
                      cuda_build (nvcc build of csrc/ at first use)
  cameras/rays.py     Rays as a dataclass of tensors
  models/             MLP, Model (the cascade), render, construct, renderer
  csrc/               the hand-written CUDA kernels (sm_90a)

Entry points: `models.construct.construct_model`,
`models.renderer.render_rays` and `models.renderer.render_image`.
The package imports torch and never jax; from refnerf_tpu it uses only the
jax-free `utils/ginlite.py` and `ops/geopoly.py`.
"""

__version__ = '0.1.0'

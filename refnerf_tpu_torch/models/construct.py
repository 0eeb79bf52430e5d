"""Model construction from Config + gin (counterpart of models/construct.py:29-64)."""

from __future__ import annotations

from typing import Optional

import torch

from refnerf_tpu_torch import configs as configs_lib
from refnerf_tpu_torch.models.mlp import MLP
from refnerf_tpu_torch.models.model import Model
from refnerf_tpu_torch.utils import ginlite


def construct_model(config, gin: Optional[ginlite.GinConfig] = None,
                    device='cuda', scope: Optional[str] = None) -> Model:
  """Build the Model from Config + gin, initialise it from `config.seed`
  with a torch.Generator, and move it to `device` in eval mode.

  The model goes to the GPU unless the caller names another device
  (`device='cpu'`); without a GPU that default raises rather than falling
  back to the CPU.
  """
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        f"construct_model: device {device} asked for, but no CUDA device is "
        "available; pass device='cpu' to build the model on the CPU")
  gin = gin or ginlite.GinConfig()
  m_kwargs = dict(configs_lib.model_kwargs(gin, scope=scope))
  single_mlp = bool(m_kwargs.pop('single_mlp', False))
  # Rematerialise each level's MLP in the backward (JAX nn.remat(MLP),
  # construct.py:36-44): its activations are recomputed instead of kept.
  remat = bool(m_kwargs.pop('remat', False))
  if isinstance(m_kwargs.get('raydist_fn'), ginlite.Ref):
    m_kwargs['raydist_fn'] = m_kwargs['raydist_fn'].name.split('.')[-1]

  # The MLPs build the parameter tree of the view directions they will get
  # (Model.use_viewdirs): without them, no bottleneck or directional trunk.
  use_viewdirs = bool(m_kwargs.get('use_viewdirs', True))
  nerf_mlp = MLP(use_viewdirs,
                 **configs_lib.mlp_kwargs(gin, 'NerfMLP', scope=scope))
  prop_mlp = None if single_mlp else MLP(
      use_viewdirs, **configs_lib.mlp_kwargs(gin, 'PropMLP', scope=scope))
  model = Model(
      nerf_mlp, prop_mlp,
      render_with_specular_density=config.render_with_specular_density,
      srgb_mapping_type=config.srgb_mapping_type,
      srgb_mapping_when_rendering=config.srgb_mapping_when_rendering,
      vis_num_rays=config.vis_num_rays,
      remat=remat,
      **m_kwargs)
  generator = torch.Generator().manual_seed(int(config.seed))
  for mlp in (nerf_mlp, prop_mlp):
    if mlp is not None:
      mlp.reset_parameters(generator)
  return model.to(device).eval()

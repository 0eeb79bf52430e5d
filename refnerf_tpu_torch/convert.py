"""JAX (flax) parameters -> the port's state_dict.

The port's modules carry the flax names (`nerf_mlp.spatial_0`, ...), so the
map is one transpose per layer: a flax Dense `kernel` [in, out] becomes an
nn.Linear `weight` [out, in]; `bias` is unchanged. Pass the parameter tree
as numpy arrays (e.g. `jax.device_get(params)`); this module imports no jax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_LEAVES = {'kernel': 'weight', 'bias': 'bias'}


def params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """Flatten {module: {layer: {kernel, bias}}} into state_dict entries."""
  out = {}
  for module, layers in params.items():
    for layer, leaves in layers.items():
      for leaf, value in leaves.items():
        if leaf not in _LEAVES:
          raise ValueError(f'unexpected leaf {module}/{layer}/{leaf}')
        arr = np.asarray(value, dtype=np.float32)
        if leaf == 'kernel':
          arr = arr.T
        out[f'{module}.{layer}.{_LEAVES[leaf]}'] = torch.from_numpy(
            np.ascontiguousarray(arr))
  return out


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any]):
  """Copy a flax parameter tree into `model`.

  Raises ValueError naming every leaf that is left over, missing, or of the
  wrong shape.
  """
  sd = params_to_state_dict(params)
  own = model.state_dict()
  extra = sorted(set(sd) - set(own))
  missing = sorted(set(own) - set(sd))
  shapes = sorted(k for k in set(sd) & set(own)
                  if tuple(sd[k].shape) != tuple(own[k].shape))
  if extra or missing or shapes:
    raise ValueError(f'parameter tree does not match the model: left over '
                     f'{extra}, missing {missing}, wrong shape {shapes}')
  model.load_state_dict(sd)

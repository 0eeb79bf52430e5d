"""JAX (flax) parameters and train state -> the port's.

The port's modules carry the flax names (`nerf_mlp.spatial_0`, ...), so the
map is one transpose per layer: a flax Dense `kernel` [in, out] becomes an
nn.Linear `weight` [out, in]; `bias` is unchanged. Pass the parameter tree
as numpy arrays (e.g. `jax.device_get(params)`); this module imports no jax.
`load_jax_train_state` carries a whole JAX TrainState (parameters, step and
Adam state), so that a JAX checkpoint continues in the port.
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


def _adam_state(tree):
  """The first node of an optax state tree with `count`, `mu` and `nu`
  (ScaleByAdamState), found without importing optax."""
  if all(hasattr(tree, k) for k in ('count', 'mu', 'nu')):
    return tree
  if isinstance(tree, (tuple, list)):
    for node in tree:
      found = _adam_state(node)
      if found is not None:
        return found
  return None


def load_jax_train_state(state, jax_state):
  """Carry a JAX TrainState (flax's: `step`, `params`, `opt_state`; leaves
  as numpy arrays, e.g. `jax.device_get(state)`) into the port's
  `train.step.TrainState`, in place: the parameters through
  `load_jax_params`, the step, and optax's Adam count, mu and nu (moved to
  each parameter's device). Returns `state`."""
  adam = _adam_state(jax_state.opt_state)
  if adam is None:
    raise ValueError('no Adam state (count, mu, nu) in the optimizer state')
  load_jax_params(state.model, jax_state.params)
  params = dict(state.model.named_parameters())
  moment = lambda tree: {
      k: v.to(device=params[k].device, dtype=params[k].dtype)
      for k, v in params_to_state_dict(tree).items()}
  mu, nu = moment(adam.mu), moment(adam.nu)
  if set(mu) != set(params) or set(nu) != set(params):
    raise ValueError('the Adam moments do not match the model parameters')
  state.step = int(np.asarray(jax_state.step))
  state.opt.count = int(np.asarray(adam.count))
  state.opt.mu, state.opt.nu = mu, nu
  return state

"""refnerf-pl checkpoint interop: Lightning state dicts <-> the port's
(counterpart of refnerf_tpu/interop.py).

refnerf-pl (minfenli/refnerf-pl) trains with PyTorch Lightning; its
checkpoints hold a `state_dict` whose MLP attribute names mirror this
port's layers one to one (`spatial_net.N` / `raw_density` / `grad_pred` /
`raw_roughness` / `raw_rgb_diffuse` / `raw_tint` / `bottleneck` /
`viewdir_mlp.N` / `rgb` under `model.nerf_mlp.` and `model.prop_mlp.`).
Both are `nn.Linear` weights [out, in], so no transpose is needed.

What does need care is the geodesic basis: both implementations project
sample Gaussians onto `geopoly.generate_basis(...)` before the IPE, but
the two tessellations list the vertices in another order and keep
antipodes of opposite sign. The basis is not stored in the checkpoint, so
a plain weight copy mis-wires every first-layer and skip-layer encoding
column. The fix is exact: this basis is a signed permutation of theirs,
`ours[j] = sign_j * theirs[sigma_j]`, under which the IPE features
transform as sin -> sign * sin, cos -> cos per (degree, basis) column;
permuting and sign-flipping those weight columns makes the imported model
equal to the exporter's bit for bit.

`KNOWN_BASIS_MAPS` holds the signed permutations of the standard basis
configurations (JAX interop.py:43-53); any other (shape, subdivisions)
needs the reference's basis matrix (`ref_basis`, e.g. dumped with
`numpy.save('basis.npy', internal.geopoly.generate_basis(shape, n))`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from refnerf_tpu_torch.models.mlp import trailing_concat
from refnerf_tpu_torch.ops import geopoly

# (basis_shape, basis_subdivisions) -> (sigma, signs) with
# ours[j] == signs[j] * theirs[sigma[j]] (JAX interop.py:43-53, matched
# vertex by vertex against the reference's internal/geopoly.py).
KNOWN_BASIS_MAPS: Dict[Tuple[str, int], Tuple[Tuple[int, ...],
                                              Tuple[int, ...]]] = {
    ('icosahedron', 2): (
        (12, 14, 2, 15, 1, 0, 5, 4, 3, 7, 17, 16, 19, 10, 20, 11, 13, 9,
         8, 6, 18),
        (-1, -1, -1, -1, -1, -1, -1, -1, -1, 1, -1, -1, 1, 1, 1, 1, -1, -1,
         -1, -1, -1)),
    ('icosahedron', 1): ((5, 1, 0, 2, 3, 4), (-1, -1, -1, -1, 1, 1)),
    ('octahedron', 1): ((2, 1, 0), (1, 1, 1)),
    ('octahedron', 2): ((5, 4, 2, 3, 1, 0, 7, 8, 6),
                        (1, 1, 1, 1, 1, 1, 1, 1, -1)),
}

# Heads fed by the spatial trunk's output. When the trunk ends in a skip
# concat, these heads read [x, encoding] and their encoding columns take
# the same signed basis permutation as spatial_0 ('rgb' reads the
# directional trunk). refnerf-pl cannot build that architecture (its heads
# are fixed nn.Linear(net_width, ...)), so no imported checkpoint reaches
# it; the remap keeps the port's trailing-skip models a bijection through
# the reference layout, as JAX's does (interop.py:117-133).
_SPATIAL_HEADS = frozenset({
    'raw_density', 'raw_specular_density', 'grad_pred', 'raw_roughness',
    'raw_rgb_diffuse', 'raw_tint', 'bottleneck'})
# The heads, named alike in both packages: the spatial ones and the
# directional trunk's rgb.
_HEADS = _SPATIAL_HEADS | {'rgb'}


def basis_signed_permutation(ours: np.ndarray, theirs: np.ndarray,
                             atol: float = 1e-6):
  """(sigma, signs) with ours[j] == signs[j] * theirs[sigma[j]]."""
  ours = np.asarray(ours, dtype=np.float64)
  theirs = np.asarray(theirs, dtype=np.float64)
  if ours.shape != theirs.shape:
    raise ValueError(f'basis shapes differ: {ours.shape} vs {theirs.shape}')
  sigma, signs = [], []
  for j, v in enumerate(ours):
    hit = np.where(np.all(np.isclose(theirs, v, atol=atol), axis=1))[0]
    neg = np.where(np.all(np.isclose(theirs, -v, atol=atol), axis=1))[0]
    if len(hit):
      sigma.append(int(hit[0]))
      signs.append(1)
    elif len(neg):
      sigma.append(int(neg[0]))
      signs.append(-1)
    else:
      raise ValueError(
          f'basis vector {j} ({v}) has no +- match in the reference basis; '
          'the two bases are not the same tessellation')
  if sorted(sigma) != list(range(len(ours))):
    raise ValueError('basis match is not a permutation (duplicate hits)')
  return tuple(sigma), tuple(signs)


def encoding_row_map(num_degs: int, sigma, signs):
  """Row permutation and signs for the [2 * num_degs * n_basis] IPE layout.

  The feature vector is [sin block | cos block], each block degree-major,
  basis-minor. Under ours = sign * theirs the sin rows take the sign and the
  cos rows do not. Returns (rows, signs): our feature i is their feature
  rows[i] times signs[i].
  """
  nb = len(sigma)
  half = num_degs * nb
  rows = np.empty(2 * half, dtype=np.int64)
  out_signs = np.ones(2 * half, dtype=np.float32)
  for d in range(num_degs):
    for jp in range(nb):
      rows[d * nb + jp] = d * nb + sigma[jp]
      out_signs[d * nb + jp] = signs[jp]
      rows[half + d * nb + jp] = half + d * nb + sigma[jp]
  return rows, out_signs


def _torch_layer_name(name: str) -> str:
  if name.startswith('spatial_'):
    return f'spatial_net.{name.split("_")[-1]}'
  if name.startswith('viewdir_'):
    return f'viewdir_mlp.{name.split("_")[-1]}'
  if name in _HEADS:
    return name
  raise KeyError(f'no torch-reference layer known for {name!r}')


def _row_map(mlp, ref_basis):
  """The encoding row map of `mlp`'s basis (KNOWN_BASIS_MAPS, or matched
  against `ref_basis`)."""
  c = mlp.cfg
  shape_key = (c.basis_shape, c.basis_subdivisions)
  if ref_basis is not None:
    ours = np.array(geopoly.generate_basis(*shape_key))
    sigma, signs = basis_signed_permutation(ours, ref_basis)
  elif shape_key in KNOWN_BASIS_MAPS:
    sigma, signs = KNOWN_BASIS_MAPS[shape_key]
  else:
    raise ValueError(
        f'no known basis mapping for {shape_key}; dump the reference basis '
        "(numpy.save('basis.npy', internal.geopoly.generate_basis"
        f'{shape_key!r})) and pass it as ref_basis')
  return encoding_row_map(c.max_deg_point - c.min_deg_point, sigma, signs)


def _encoding_input(name: str, mlp) -> str:
  """Which columns of layer `name` read the IPE: 'all' (spatial_0), 'skip'
  (the columns past net_width: a skip layer, or a head after a trailing
  skip concat) or '' (none)."""
  c = mlp.cfg
  if name == 'spatial_0':
    return 'all'
  if name.startswith('spatial_'):
    i = int(name.split('_')[-1])
    return 'skip' if i > 1 and (i - 1) % c.skip_layer == 0 else ''
  if name in _SPATIAL_HEADS and trailing_concat(c.net_depth, c.skip_layer):
    return 'skip'
  return ''


def _layers(sub: Mapping[str, Any]):
  """Layer names of a module's state dict, in its order."""
  return list(dict.fromkeys(k.rsplit('.', 1)[0] for k in sub))


def convert_mlp(state_dict: Mapping[str, Any], prefix: str,
                template: Mapping[str, Any], mlp,
                ref_basis: Optional[np.ndarray] = None) -> Dict[str, Any]:
  """Convert one reference MLP's weights into the port's layout.

  Args:
    state_dict: the reference state dict (tensors or arrays), e.g. a
      Lightning checkpoint's `state_dict` entry.
    prefix: key prefix of this MLP, e.g. 'model.nerf_mlp.'.
    template: the port MLP's state dict ('spatial_0.weight', ...) to mirror.
    mlp: the port MLP (for its net_width, skip_layer, degrees and basis).
    ref_basis: the reference basis matrix [n_basis, 3] for non-standard
      basis configurations; KNOWN_BASIS_MAPS by default.

  Returns {'<layer>.weight': [out, in], '<layer>.bias': [out]} float32
  arrays; raises on a missing layer or a shape mismatch.
  """
  rows, row_signs = _row_map(mlp, ref_basis)
  n_enc = len(rows)
  nw = mlp.cfg.net_width

  def fetch(key):
    if key not in state_dict:
      near = [k for k in state_dict if key.rsplit('.', 2)[-2] in k][:4]
      raise KeyError(f'{key!r} missing from state_dict (architecture '
                     f'mismatch? nearby keys: {near})')
    return np.asarray(state_dict[key], dtype=np.float32)

  out: Dict[str, Any] = {}
  for name in _layers(template):
    tname = _torch_layer_name(name)
    weight = fetch(f'{prefix}{tname}.weight').copy()
    bias = fetch(f'{prefix}{tname}.bias').copy()
    enc = _encoding_input(name, mlp)
    if enc == 'all':
      if weight.shape[1] != n_enc:
        raise ValueError(
            f'{prefix}{tname}: input dim {weight.shape[1]} != encoding '
            f'{n_enc} (min/max_deg_point or basis mismatch)')
      weight = weight[:, rows] * row_signs[None, :]
    elif enc == 'skip':
      if weight.shape[1] - nw != n_enc:
        raise ValueError(
            f'{prefix}{tname}: skip-input columns {weight.shape[1] - nw} != '
            f'encoding {n_enc}')
      weight = np.concatenate(
          [weight[:, :nw], weight[:, nw:][:, rows] * row_signs[None, :]],
          axis=1)
    want = tuple(template[f'{name}.weight'].shape)
    if weight.shape != want:
      raise ValueError(f'{prefix}{tname}: weight shape {weight.shape} != '
                       f'expected {want} (config mismatch)')
    out[f'{name}.weight'] = weight
    out[f'{name}.bias'] = bias
  return out


def _mlp_to_state_dict(sub: Mapping[str, Any], prefix: str, mlp,
                       ref_basis: Optional[np.ndarray] = None
                       ) -> Dict[str, np.ndarray]:
  """Inverse of convert_mlp: the port MLP's state dict -> reference keys."""
  rows, row_signs = _row_map(mlp, ref_basis)
  inv_rows = np.empty_like(rows)
  inv_rows[rows] = np.arange(len(rows))
  inv_signs = row_signs[inv_rows]
  nw = mlp.cfg.net_width

  out: Dict[str, np.ndarray] = {}
  for name in _layers(sub):
    weight = _numpy(sub[f'{name}.weight'])
    enc = _encoding_input(name, mlp)
    if enc == 'all':
      weight = weight[:, inv_rows] * inv_signs[None, :]
    elif enc == 'skip':
      weight = np.concatenate(
          [weight[:, :nw], weight[:, nw:][:, inv_rows] * inv_signs[None, :]],
          axis=1)
    tname = _torch_layer_name(name)
    out[f'{prefix}{tname}.weight'] = np.ascontiguousarray(weight)
    out[f'{prefix}{tname}.bias'] = _numpy(sub[f'{name}.bias']).copy()
  return out


def _numpy(t):
  return torch.as_tensor(t).detach().to('cpu', torch.float32).numpy()


def _groups(params: Mapping[str, Any]):
  """{'nerf_mlp': {'spatial_0.weight': ...}, 'prop_mlp': {...}} of a
  Model's state dict; raises on any other parameter group (JAX
  interop.py:298-300)."""
  out: Dict[str, Dict[str, Any]] = {}
  for k, v in params.items():
    group, rest = k.split('.', 1)
    out.setdefault(group, {})[rest] = v
  extra = set(out) - {'nerf_mlp', 'prop_mlp'}
  if extra:
    raise ValueError(f'unexpected non-MLP param groups: {sorted(extra)}')
  return out


def params_to_torch_state_dict(params: Mapping[str, Any], model,
                               ref_basis: Optional[np.ndarray] = None
                               ) -> Dict[str, np.ndarray]:
  """Export the port's parameters (a Model's state dict) as a
  reference-layout state dict.

  The exact inverse of torch_state_dict_to_params: keys are
  'model.nerf_mlp.*' (plus 'model.prop_mlp.*' when two MLPs exist, or
  aliased to the NeRF weights under single_mlp so that the reference's
  shared-module layout loads).
  """
  groups = _groups(params)
  out = _mlp_to_state_dict(groups['nerf_mlp'], 'model.nerf_mlp.',
                           model.nerf_mlp, ref_basis=ref_basis)
  if 'prop_mlp' in groups:
    out.update(_mlp_to_state_dict(groups['prop_mlp'], 'model.prop_mlp.',
                                  model.prop_mlp, ref_basis=ref_basis))
  else:
    out.update({k.replace('model.nerf_mlp.', 'model.prop_mlp.'): v
                for k, v in list(out.items())})
  return out


def torch_state_dict_to_params(state_dict: Mapping[str, Any], params, model,
                               ref_basis: Optional[np.ndarray] = None
                               ) -> Dict[str, torch.Tensor]:
  """Convert a reference Lightning state dict into the port's parameters.

  `params` is the template (the constructed Model's state dict) and `model`
  the Model (for its MLPs' fields). Returns a new state dict of float32
  CPU tensors for `model.load_state_dict`; raises on any missing layer or
  shape mismatch, on a parameter group other than the MLPs', and on
  distinct proposal weights under single_mlp.
  """
  groups = _groups(params)
  out: Dict[str, torch.Tensor] = {}
  for group, prefix, mlp in (('nerf_mlp', 'model.nerf_mlp.', model.nerf_mlp),
                             ('prop_mlp', 'model.prop_mlp.', model.prop_mlp)):
    if group not in groups:
      continue
    converted = convert_mlp(state_dict, prefix, groups[group], mlp,
                            ref_basis=ref_basis)
    out.update({f'{group}.{k}': torch.from_numpy(v)
                for k, v in converted.items()})
  if 'prop_mlp' not in groups:
    # single_mlp: the reference's shared-module layout aliases
    # model.prop_mlp.* to the NeRF weights. DISTINCT proposal weights mean
    # the checkpoint was trained with two MLPs, and this config would drop
    # them.
    for k in state_dict:
      if not k.startswith('model.prop_mlp.'):
        continue
      nk = 'model.nerf_mlp.' + k[len('model.prop_mlp.'):]
      if nk in state_dict and not np.array_equal(
          np.asarray(state_dict[k]), np.asarray(state_dict[nk])):
        raise ValueError(
            f'checkpoint has distinct prop_mlp weights ({k} != {nk}) but '
            'the config is single_mlp; bind Model.single_mlp = False to '
            'import both MLPs')
  return out

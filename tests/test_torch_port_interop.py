"""refnerf-pl checkpoint interop (refnerf_tpu_torch/interop.py and the
import and export tools) against the JAX package's, on the CPU.

- Import: JAX's `interop.params_to_torch_state_dict` writes a Lightning
  `.ckpt`; the port's import tool reads it and writes a port checkpoint,
  whose weights equal `convert.load_jax_params` of the same JAX parameters
  exactly (torch.equal), with the ckpt's global_step or `--step`. Cases:
  the 2-level `single_mlp` flagship cut and a 3-level cascade with a
  separate PropMLP, each with the known basis maps and with a seeded
  signed permutation passed as `--ref_basis`.
- Export: the port's export tool writes a `.ckpt` from a port checkpoint;
  JAX's `torch_state_dict_to_params` reads it back into JAX's parameters
  exactly, and its keys and tensors equal JAX's own export.
- The port's round trip is the identity, also on a trunk ending in a skip
  concat (the heads' encoding columns permuted too).
- The refusals of JAX's interop raise in the port too: a missing layer, a
  shape mismatch, an encoding of another width, distinct proposal weights
  under single_mlp, a parameter group that is not an MLP, an unknown basis
  without `ref_basis`, a `ref_basis` of another tessellation.
- A checkpoint that pickles more than tensors loads after the printed
  warning (the full unpickling).
"""

import argparse
import os

import jax
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu import interop as jinterop
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch import interop
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.ops import geopoly
from refnerf_tpu_torch.tools import export_torch_checkpoint
from refnerf_tpu_torch.tools import import_torch_checkpoint
from refnerf_tpu_torch.train import checkpoints as ckpt_lib
from refnerf_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_refnerf.gin')
SMALL = ['NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
         'NerfMLP.net_depth_viewdirs = 2', 'NerfMLP.net_width_viewdirs = 32',
         'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16']
# A separate PropMLP at JAX's MLP defaults (icosahedron basis of 21, 12
# degrees: 504 encoding columns), cut to a small width.
CASCADE = SMALL + ['Model.num_levels = 3', 'Model.single_mlp = False',
                   'PropMLP.net_depth = 6', 'PropMLP.net_width = 16',
                   'PropMLP.bottleneck_width = 8',
                   'PropMLP.net_width_viewdirs = 16']
# One ref_basis serves both MLPs, so the PropMLP takes the NeRF MLP's basis.
SAME_BASIS = ["PropMLP.basis_shape = 'octahedron'",
              'PropMLP.basis_subdivisions = 1']
CASES = {'single_mlp': SMALL, 'cascade': CASCADE}


def _jax(bindings, seed=0):
  """JAX's model and its parameters (seeded bias noise added), as numpy."""
  config, gin = jconfigs.parse([GIN], bindings)
  model = jconstruct.construct_model(config, gin)
  params = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(seed),
                                                 model))
  rng = np.random.default_rng(seed)
  return model, jax.tree_util.tree_map_with_path(
      lambda path, x: np.asarray(x) + (
          rng.normal(size=x.shape).astype(np.float32) * 0.1
          if path[-1].key == 'bias' else 0.0), params)


def _port(bindings, params=None, seed=0):
  config, gin = configs.parse([GIN], [f'Config.seed = {seed}'] + bindings)
  model = construct.construct_model(config, gin, 'cpu')
  if params is not None:
    convert.load_jax_params(model, params)
  return model


def _signed_permutation(shape, subdivisions, seed):
  """A reference basis whose vertices are ours, reordered and some
  negated: theirs[sigma[j]] = signs[j] * ours[j]."""
  ours = np.array(geopoly.generate_basis(shape, subdivisions))
  rng = np.random.default_rng(seed)
  sigma = rng.permutation(len(ours))
  signs = rng.choice([-1.0, 1.0], len(ours))
  # Seeds are chosen so that both the order and some signs change.
  assert (sigma != np.arange(len(ours))).any() and (signs < 0).any()
  theirs = np.empty_like(ours)
  theirs[sigma] = signs[:, None] * ours
  return theirs


def _save_lightning(path, sd, step, **extra):
  torch.save({'state_dict': {k: torch.from_numpy(np.array(v))
                             for k, v in sd.items()},
              'global_step': step, **extra}, path)


def _gin_args(bindings, root, exp):
  out = ['--gin_configs', GIN, '--device=cpu']
  for b in bindings + [f"Config.checkpoint_dir = '{root}'",
                       f"Config.exp_name = '{exp}'"]:
    out += ['--gin_bindings', b]
  return out


def _restored(bindings, root, exp):
  """The port checkpoint written under `exp`, restored into a model built
  from another seed (so that nothing is left from the build)."""
  model = _port(bindings, seed=5)
  config, _ = configs.parse([GIN], bindings + [
      f"Config.checkpoint_dir = '{root}'", f"Config.exp_name = '{exp}'"])
  state = step_lib.create_train_state(config, model)
  ckpt_lib.CheckpointManager(ckpt_lib.checkpoint_dir(config)).restore(state)
  return state


@pytest.mark.parametrize('ref', ['known maps', 'ref_basis'])
@pytest.mark.parametrize('case', list(CASES))
def test_import_of_a_jax_export_equals_load_jax_params(tmp_path, case, ref):
  bindings = CASES[case] + (SAME_BASIS if case == 'cascade' and
                            ref == 'ref_basis' else [])
  jmodel, params = _jax(bindings)
  ref_basis, extra = None, []
  if ref == 'ref_basis':
    ref_basis = _signed_permutation('octahedron', 1, seed=5)
    np.save(str(tmp_path / 'basis.npy'), ref_basis)
    extra = ['--ref_basis', str(tmp_path / 'basis.npy')]
  sd = jinterop.params_to_torch_state_dict(params, jmodel,
                                           ref_basis=ref_basis)
  ckpt = str(tmp_path / 'last.ckpt')
  _save_lightning(ckpt, sd, 1234)
  import_torch_checkpoint.main(
      ['--ckpt', ckpt] + extra + _gin_args(bindings, tmp_path, 'imp_a'))
  import_torch_checkpoint.main(
      ['--ckpt', ckpt, '--step', '7'] + extra +
      _gin_args(bindings, tmp_path, 'imp_b'))

  want = _port(bindings, params).state_dict()
  for exp, step in (('imp_a', 1234), ('imp_b', 7)):
    state = _restored(bindings, tmp_path, exp)
    assert state.step == step and state.opt.count == 0
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
      assert torch.equal(got[k], v), (exp, k)
    for moments in (state.opt.mu, state.opt.nu):
      assert all(not m.any() for m in moments.values())


@pytest.mark.parametrize('ref', ['known maps', 'ref_basis'])
@pytest.mark.parametrize('case', list(CASES))
def test_export_reads_back_into_jax(tmp_path, case, ref):
  bindings = CASES[case] + (SAME_BASIS if case == 'cascade' and
                            ref == 'ref_basis' else [])
  jmodel, params = _jax(bindings, seed=1)
  ref_basis, extra = None, []
  if ref == 'ref_basis':
    ref_basis = _signed_permutation('octahedron', 1, seed=9)
    np.save(str(tmp_path / 'basis.npy'), ref_basis)
    extra = ['--ref_basis', str(tmp_path / 'basis.npy')]
  model = _port(bindings, params)
  config, _ = configs.parse([GIN], bindings + [
      f"Config.checkpoint_dir = '{tmp_path}'", "Config.exp_name = 'exp_a'"])
  state = step_lib.create_train_state(config, model)
  state.step = 42
  ckpt_lib.CheckpointManager(ckpt_lib.checkpoint_dir(config)).save(42, state)

  out = str(tmp_path / 'exported.ckpt')
  export_torch_checkpoint.main(['--out', out] + extra +
                               _gin_args(bindings, tmp_path, 'exp_a'))
  ckpt = torch.load(out, map_location='cpu', weights_only=True)
  assert ckpt['global_step'] == 42
  sd = ckpt['state_dict']
  want = jinterop.params_to_torch_state_dict(params, jmodel,
                                             ref_basis=ref_basis)
  assert set(sd) == set(want)
  for k, v in want.items():
    assert sd[k].dtype == torch.float32
    np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
  back = jinterop.torch_state_dict_to_params(sd, params, jmodel,
                                             ref_basis=ref_basis)
  jax.tree_util.tree_map(np.testing.assert_array_equal,
                         jax.tree_util.tree_map(np.asarray, back), params)


@pytest.mark.parametrize('bindings', [
    SMALL, CASCADE,
    # A spatial trunk ending in a skip concat (depth 5, skip 4): the heads
    # read [x, encoding].
    SMALL + ['NerfMLP.net_depth = 5', 'NerfMLP.skip_layer = 4']])
def test_round_trip_is_the_identity(bindings):
  model = _port(bindings, seed=2)
  params = model.state_dict()
  sd = interop.params_to_torch_state_dict(params, model)
  back = interop.torch_state_dict_to_params(sd, params, model)
  assert set(back) == set(params)
  for k, v in params.items():
    assert torch.equal(back[k], v), k
  # The layout JAX writes for the same weights.
  jmodel, jparams = _jax(bindings)
  other = _port(bindings, jparams)
  jsd = jinterop.params_to_torch_state_dict(jparams, jmodel)
  psd = interop.params_to_torch_state_dict(other.state_dict(), other)
  assert set(psd) == set(jsd)
  for k, v in jsd.items():
    np.testing.assert_array_equal(psd[k], v, err_msg=k)


def _raises_like_jax(port_fn, jax_fn, match):
  with pytest.raises(Exception) as want:
    jax_fn()
  with pytest.raises(type(want.value), match=match):
    port_fn()


def test_refusals_match_jax():
  jmodel, params = _jax(SMALL)
  model = _port(SMALL, params)
  template = model.state_dict()
  sd = jinterop.params_to_torch_state_dict(params, jmodel)
  port = lambda s, m=model, t=None, **kw: interop.torch_state_dict_to_params(
      s, template if t is None else t, m, **kw)

  missing = {k: v for k, v in sd.items()
             if k != 'model.nerf_mlp.spatial_net.1.weight'}
  _raises_like_jax(lambda: port(missing),
                   lambda: jinterop.torch_state_dict_to_params(
                       missing, params, jmodel), 'missing from state_dict')

  for what, more, match in (
      ('width', ['NerfMLP.net_width = 16'], 'shape'),
      ('encoding', ['NerfMLP.max_deg_point = 12'], 'encoding'),
      ('basis', ['NerfMLP.basis_subdivisions = 3'], 'no known basis')):
    jm, jp = _jax(SMALL + more)
    m = _port(SMALL + more, jp)
    _raises_like_jax(lambda: port(sd, m, m.state_dict()),
                     lambda: jinterop.torch_state_dict_to_params(sd, jp, jm),
                     match)

  # A cascade's distinct proposal weights into a single_mlp config.
  cm, cp = _jax(CASCADE)
  csd = jinterop.params_to_torch_state_dict(cp, cm)
  _raises_like_jax(lambda: port(csd),
                   lambda: jinterop.torch_state_dict_to_params(
                       csd, params, jmodel), 'distinct prop_mlp')

  extra = dict(template, **{'embed.weight': torch.zeros(2)})
  _raises_like_jax(lambda: port(sd, t=extra),
                   lambda: jinterop.torch_state_dict_to_params(
                       sd, dict(params, embed={}), jmodel),
                   'non-MLP param groups')

  wrong = np.array(geopoly.generate_basis('icosahedron', 1))[:3]
  _raises_like_jax(lambda: port(sd, ref_basis=wrong),
                   lambda: jinterop.torch_state_dict_to_params(
                       sd, params, jmodel, ref_basis=wrong),
                   'no \\+- match')
  for fn in (interop.basis_signed_permutation,
             jinterop.basis_signed_permutation):
    with pytest.raises(ValueError, match='shapes differ'):
      fn(np.eye(3), np.eye(4)[:, :3])


def test_known_maps_and_row_map_are_jax():
  assert interop.KNOWN_BASIS_MAPS == jinterop.KNOWN_BASIS_MAPS
  theirs = _signed_permutation('icosahedron', 2, seed=9)
  ours = np.array(geopoly.generate_basis('icosahedron', 2))
  got = interop.basis_signed_permutation(ours, theirs)
  assert got == jinterop.basis_signed_permutation(ours, theirs)
  for a, b in zip(interop.encoding_row_map(12, *got),
                  jinterop.encoding_row_map(12, *got)):
    np.testing.assert_array_equal(a, b)


def test_import_unpickles_a_full_lightning_checkpoint(tmp_path, capsys):
  jmodel, params = _jax(SMALL)
  sd = jinterop.params_to_torch_state_dict(params, jmodel)
  ckpt = str(tmp_path / 'full.ckpt')
  # Lightning pickles its hyper-parameters; weights_only refuses them.
  _save_lightning(ckpt, sd, 9, hyper_parameters=argparse.Namespace(lr=0.1))
  state_dict, step = import_torch_checkpoint.load_lightning(ckpt)
  assert 'weights_only load failed' in capsys.readouterr().out
  assert step == 9 and set(state_dict) == set(sd)
  for k, v in sd.items():
    np.testing.assert_array_equal(state_dict[k], v)

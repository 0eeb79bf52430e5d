"""Export a checkpoint of the port as a refnerf-pl Lightning .ckpt
(counterpart of tools/export_torch_checkpoint.py).

The inverse of `tools/import_torch_checkpoint.py`: a model trained here
loads back into the PyTorch reference, or any tooling that expects its
layout:

    python3 -m refnerf_tpu_torch.tools.export_torch_checkpoint \
        --gin_configs=exps/logs/lego/lego_refnerf/config.gin \
        --out=exported.ckpt [--ref_basis=basis.npy] [--step=N] [--device=cuda]

The file holds {'state_dict': model.nerf_mlp.* / model.prop_mlp.* tensors,
'global_step': step}; the geodesic basis's signed permutation is inverted,
so that the reference's own basis order sees the same weights
(`refnerf_tpu_torch/interop.py`). The model is built on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import numpy as np
import torch

from refnerf_tpu_torch.cli import flags


def _arguments(parser):
  parser.add_argument('--out', required=True, help='Output .ckpt path.')
  parser.add_argument('--ref_basis', default='',
                      help='Optional .npy reference basis for non-standard '
                           'basis configs.')
  parser.add_argument('--step', type=int, default=-1,
                      help='Checkpoint step (-1 = newest).')


def export(model, step, path, ref_basis=None):
  """Write `model`'s weights as a refnerf-pl checkpoint at `path`; returns
  the state dict written."""
  from refnerf_tpu_torch import interop
  sd = interop.params_to_torch_state_dict(model.state_dict(), model,
                                          ref_basis=ref_basis)
  torch.save({'state_dict': {k: torch.from_numpy(v) for k, v in sd.items()},
              'global_step': int(step)}, path)
  return sd


def main(argv=None):
  config, gin, args = flags.load_config(argv, __doc__, None, False,
                                        _arguments)
  from refnerf_tpu_torch.models import construct
  from refnerf_tpu_torch.train import checkpoints as ckpt_lib
  from refnerf_tpu_torch.train import step as step_lib

  model = construct.construct_model(config, gin, args.device)
  state = step_lib.create_train_state(config, model)
  mgr = ckpt_lib.CheckpointManager(ckpt_lib.checkpoint_dir(config))
  state = mgr.restore(state, step=None if args.step < 0 else args.step)
  ref_basis = np.load(args.ref_basis) if args.ref_basis else None
  sd = export(model, state.step, args.out, ref_basis)
  print(f'Exported step {int(state.step)} ({len(sd)} tensors) -> {args.out}')
  return sd


if __name__ == '__main__':
  main()

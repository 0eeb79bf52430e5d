"""Import a refnerf-pl (PyTorch Lightning) checkpoint into the port
(counterpart of tools/import_torch_checkpoint.py).

One command converts a reference `.ckpt` into a checkpoint of the port's
format (`train/checkpoints.py`) that its eval and render CLIs read:

    python3 -m refnerf_tpu_torch.tools.import_torch_checkpoint \
        --ckpt=last.ckpt --gin_configs=configs/blender_refnerf.gin \
        --gin_bindings="Config.checkpoint_dir = 'exps'" \
        --gin_bindings="Config.exp_name = 'imported'" \
        [--ref_basis=basis.npy] [--step=N] [--device=cuda]

The gin config must describe the architecture the checkpoint was trained
with (the reference stores none in the ckpt). Layer names map one to one;
the geodesic basis's vertex order, which differs between the two
implementations, is corrected exactly by a signed permutation of the
encoding columns (`refnerf_tpu_torch/interop.py`). Optimizer moments are
not carried: the imported checkpoint serves evaluation, rendering and
fine-tuning from a fresh optimizer state. The model is built on the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import numpy as np
import torch

from refnerf_tpu_torch.cli import flags


def _arguments(parser):
  parser.add_argument('--ckpt', required=True,
                      help='Path to the Lightning .ckpt file.')
  parser.add_argument('--ref_basis', default='',
                      help='Optional .npy with the reference basis matrix '
                           '[n_basis, 3] for non-standard basis configs.')
  parser.add_argument('--step', type=int, default=-1,
                      help="Step to record (-1 = the ckpt's global_step).")


def load_lightning(path):
  """A Lightning checkpoint's (state dict as numpy arrays, global_step).
  Tensors alone load first; the full unpickling runs only if that fails."""
  try:
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
  except Exception as e:  # Lightning ckpts may pickle hyper_parameters etc.
    print(f'weights_only load failed ({type(e).__name__}); retrying with '
          'full unpickling - only do this with checkpoints you trust.')
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
  state_dict = ckpt.get('state_dict', ckpt)
  state_dict = {k: torch.as_tensor(v).detach().float().numpy()
                for k, v in state_dict.items()}
  return state_dict, int(ckpt.get('global_step', 0))


def main(argv=None):
  config, gin, args = flags.load_config(argv, __doc__, None, False,
                                        _arguments)
  from refnerf_tpu_torch import interop
  from refnerf_tpu_torch.models import construct
  from refnerf_tpu_torch.train import checkpoints as ckpt_lib
  from refnerf_tpu_torch.train import step as step_lib

  model = construct.construct_model(config, gin, args.device)
  state_dict, global_step = load_lightning(args.ckpt)
  step = global_step if args.step < 0 else args.step
  ref_basis = np.load(args.ref_basis) if args.ref_basis else None
  model.load_state_dict(interop.torch_state_dict_to_params(
      state_dict, model.state_dict(), model, ref_basis=ref_basis))

  state = step_lib.create_train_state(config, model)
  state.step = step
  out_dir = ckpt_lib.checkpoint_dir(config)
  ckpt_lib.CheckpointManager(out_dir).save(step, state)
  print(f'Imported {args.ckpt} -> {out_dir} at step {step}')
  return state


if __name__ == '__main__':
  main()

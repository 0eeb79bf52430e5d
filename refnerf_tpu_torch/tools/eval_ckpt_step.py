"""Evaluate one chosen checkpoint step, e.g. the best one kept by the
top-k policy (counterpart of tools/eval_ckpt_step.py).

The eval CLI evaluates the newest checkpoint; this tool restores any
saved step (by default the one of highest val PSNR that `best/` retains)
and runs the same `NeRFSystem.test` loop print-only, so no file of
test_preds/ is overwritten and a run whose validation declined can compare
its best and its last checkpoints after the fact.

    python3 -m refnerf_tpu_torch.tools.eval_ckpt_step --step=best \
        --gin_configs=... [--gin_bindings=...] [--device=cuda]
    python3 -m refnerf_tpu_torch.tools.eval_ckpt_step --step=5000 ...

The eval CLI's flags (`cli/flags.py`, gin scope 'eval') and `--step`
(`best` or a step number). The model runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from refnerf_tpu_torch.cli import flags


def main(argv=None):
  config, gin, args = flags.load_config(
      argv, __doc__, 'eval', False,
      lambda p: p.add_argument('--step', default='best',
                               help="checkpoint step, or 'best'"))
  config.eval_save_output = False  # print-only: never clobber test_preds
  random.seed(config.seed)
  np.random.seed(config.seed)
  torch.manual_seed(config.seed)

  from refnerf_tpu_torch.system import NeRFSystem
  from refnerf_tpu_torch.train import checkpoints as ckpt_lib

  system = NeRFSystem(config, gin, device=args.device)
  mgr = ckpt_lib.CheckpointManager(
      ckpt_lib.checkpoint_dir(config), save_top_k=config.save_top_k)
  step = mgr.best_step() if args.step == 'best' else int(args.step)
  if step is None:
    raise SystemExit('no best/ checkpoint retained for this experiment')
  system.state = mgr.restore(system.state, step=step)
  print(f'Evaluating checkpoint at step {step} '
        f'(policy: {"best val_psnr" if args.step == "best" else "explicit"})')
  return system.test(step=step)


if __name__ == '__main__':
  main()

"""Evaluation CLI (counterpart of eval.py): loads the newest checkpoint and
runs the test loop.

    python3 -m refnerf_tpu_torch.cli.eval --gin_configs=configs/... \
        [--gin_bindings=...] [--device=cuda]

Under torchrun each frame's chunks split across the ranks (flags.py,
`--dist_backend`), and rank 0 writes the files.

The JAX CLI's flags under the 'eval' gin scope. Writes metric_*.txt, their
colour-corrected metric_cc_*.txt, render_times.txt and avg_metrics.txt next
to the checkpoints. With Config.eval_only_once = False, keeps polling for
new checkpoints and evaluates each as it appears (eval beside training),
until one reaches max_steps.
"""

import random
import time

import numpy as np
import torch

from refnerf_tpu_torch.cli import flags

CHECKPOINT_POLL_SECS = 30


def main(argv=None):
  config, gin, args = flags.load_config(argv, __doc__, 'eval', False)
  random.seed(config.seed)
  np.random.seed(config.seed)
  torch.manual_seed(config.seed)

  from refnerf_tpu_torch.parallel import mesh
  from refnerf_tpu_torch.system import NeRFSystem

  group, device = flags.distributed(args)
  try:
    system = NeRFSystem(config, gin, device=device, group=group)
    last_evaluated = None
    while True:
      step = system.restore_latest()
      if step != last_evaluated:
        if mesh.is_first(group):
          print(f'Evaluating checkpoint at step {step}')
        system.test(step=step)
        last_evaluated = step
      if config.eval_only_once or step >= config.max_steps:
        break
      time.sleep(CHECKPOINT_POLL_SECS)
  finally:
    mesh.destroy(group)
  return system


if __name__ == '__main__':
  main()

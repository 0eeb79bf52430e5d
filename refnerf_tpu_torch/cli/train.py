"""Training CLI (counterpart of train.py):

    python3 -m refnerf_tpu_torch.cli.train --gin_configs=configs/... \
        [--gin_bindings=...] [--device=cuda]
    python3 -m torch.distributed.run --nproc_per_node N \
        -m refnerf_tpu_torch.cli.train --gin_configs=... [--dist_backend=nccl]

The JAX CLI's flags under the 'train' gin scope. Seeds Python's, numpy's
and torch's RNGs, builds the NeRFSystem and runs the training loop
(validation and top-k checkpoints on val/psnr inside). TensorBoard
summaries go to `<checkpoint_dir>/logs/<exp prefix>/<exp>` through
tensorboardX, or torch.utils.tensorboard where it is absent; with neither,
one line on stderr says so and no summaries are written. Under torchrun it
trains data-parallel, one rank a card (flags.py, `--dist_backend`), and
rank 0 alone writes the summaries.
"""

import os
import random
import sys

import numpy as np
import torch

from refnerf_tpu_torch import configs as configs_lib
from refnerf_tpu_torch.cli import flags


def setup_seed(seed):
  random.seed(seed)
  np.random.seed(seed)
  torch.manual_seed(seed)


def summary_writer(log_dir):
  """A TensorBoard writer on `log_dir`, or None without one."""
  try:
    from tensorboardX import SummaryWriter
  except ImportError:
    try:
      from torch.utils.tensorboard import SummaryWriter
    except ImportError:
      print('train: neither tensorboardX nor torch.utils.tensorboard '
            'imports; no TensorBoard summaries are written', file=sys.stderr)
      return None
  os.makedirs(log_dir, exist_ok=True)
  return SummaryWriter(log_dir)


def main(argv=None):
  config, gin, args = flags.load_config(argv, __doc__, 'train', True)
  setup_seed(config.seed)
  group, device = flags.distributed(args)

  from refnerf_tpu_torch.parallel import mesh
  from refnerf_tpu_torch.system import NeRFSystem

  writer = None
  if mesh.is_first(group):
    writer = summary_writer(configs_lib.exp_dir(config, 'logs'))
  try:
    system = NeRFSystem(config, gin, summary_writer=writer, device=device,
                        group=group)
    system.train()
  finally:
    if writer is not None:
      writer.close()
    mesh.destroy(group)
  return system


if __name__ == '__main__':
  main()

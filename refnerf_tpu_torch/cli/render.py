"""Path-rendering CLI (counterpart of render.py): renders the test split or
a camera path from the newest checkpoint.

    python3 -m refnerf_tpu_torch.cli.render --gin_configs=configs/... \
        [--gin_bindings=...] [--device=cuda]

Under torchrun each frame's chunks split across the ranks (flags.py,
`--dist_backend`), and rank 0 writes the files.

The JAX CLI's flags under the 'render' gin scope. Frames land in
`<ckpt dir>/path_renders_step_N/` (or `test_preds_step_N/`); rendering is
resumable and strided across jobs by Config.render_job_id and
render_num_jobs, and the videos are made once every frame exists.
"""

import os
import random

import numpy as np
import torch

from refnerf_tpu_torch.cli import flags


def main(argv=None):
  config, gin, args = flags.load_config(argv, __doc__, 'render', False)
  random.seed(config.seed + config.render_job_id)
  np.random.seed(config.seed + config.render_job_id)
  torch.manual_seed(config.seed + config.render_job_id)

  from refnerf_tpu_torch.data import datasets as datasets_lib
  from refnerf_tpu_torch.parallel import mesh
  from refnerf_tpu_torch.system import NeRFSystem
  from refnerf_tpu_torch.train import checkpoints as ckpt_lib

  dataset = datasets_lib.load_dataset('test', config.data_dir, config)

  group, device = flags.distributed(args)
  try:
    system = NeRFSystem(config, gin, device=device, group=group)
    step = system.restore_latest()
    if mesh.is_first(group):
      print(f'Rendering checkpoint at step {step}')

    base_dir = ckpt_lib.checkpoint_dir(config)
    out_name = 'path_renders' if config.render_path else 'test_preds'
    out_name = f'{out_name}_step_{step}'
    out_dir = os.path.join(base_dir, out_name)

    writers = system.render(dataset, base_dir, out_dir, out_name)
    if writers:
      print(f'Video writers: {sorted(set(writers.values()))}')
  finally:
    mesh.destroy(group)
  return system


if __name__ == '__main__':
  main()

"""The flags shared by the train, eval and render CLIs (JAX
configs.py:188-193, on argparse instead of absl).

`--gin_configs` and `--gin_bindings` repeat; `--flag=value` and `--flag
value` both parse. `--mode` and `--base_folder` are accepted and unused, as
in the JAX package. `--device` is the port's own: where the model runs
('cuda' by default; 'cpu' on a machine without a card). So is
`--dist_backend`, under torchrun (parallel/mesh.py): 'nccl' (the default
on a card; one card a rank, cuda:LOCAL_RANK) or 'gloo' (the default on the
CPU; ranks may share a card named by --device cuda:K). Without torchrun's
environment it is unused. Under torchrun only rank 0 writes the merged
config. A tool adds its own flags through `add_arguments(parser)`.
"""

from __future__ import annotations

import argparse
import os

from refnerf_tpu_torch import configs as configs_lib


def load_config(argv, description, scope, save_config, add_arguments=None):
  """Parse `argv` (sys.argv[1:] when None) and the gin it names: (Config,
  gin, the flags)."""
  parser = argparse.ArgumentParser(description=description)
  parser.add_argument('--mode', default=None, help='Unused; kept for parity.')
  parser.add_argument('--base_folder', default=None,
                      help='Unused; kept for parity.')
  parser.add_argument('--gin_configs', action='append', default=None,
                      help='Gin config files (repeatable).')
  parser.add_argument('--gin_bindings', action='append', default=None,
                      help='Gin parameter bindings (repeatable).')
  parser.add_argument('--device', default='cuda',
                      help="Device of the model ('cuda' or 'cpu').")
  parser.add_argument('--dist_backend', default=None, choices=('nccl', 'gloo'),
                      help='Process-group backend under torchrun (default: '
                      'nccl on a card, gloo on the CPU).')
  if add_arguments is not None:
    add_arguments(parser)
  args = parser.parse_args(argv)
  save_config = save_config and os.environ.get('RANK', '0') == '0'
  config, gin = configs_lib.load_config(args.gin_configs, args.gin_bindings,
                                        scope=scope, save_config=save_config)
  return config, gin, args


def distributed(args):
  """(group, device) of this process: torchrun's process group on the
  rank's device (parallel.mesh.initialize_distributed), or (None, the
  device flag) without torchrun."""
  from refnerf_tpu_torch.parallel import mesh
  return mesh.initialize_distributed(args.device, args.dist_backend)

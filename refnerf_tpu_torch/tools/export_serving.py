"""Export a trained checkpoint as a standalone serving artifact
(counterpart of tools/export_serving.py).

One command turns an experiment into a single weight-embedded
`torch.export` file (refnerf_tpu_torch/serving.py) that a serving host
loads with torch and this package, without the gin configs or the
checkpoint:

    python3 -m refnerf_tpu_torch.tools.export_serving \
        --gin_configs=<ckpt>/logs/<exp>/config.gin \
        --out=/tmp/scene.rnsrv [--chunk=8192] [--extras] [--step=N] \
        [--fused on|off] [--device=cuda]

The gin snapshot written by the train CLI is the natural input: it pins
the architecture exactly as trained. By default the export runs under
`fused_trunk='on'`: the trunks run as the hand-written kernels' operator,
and a trunk with no kernel instance raises here, at export. `--fused off`
writes the plain artifact, as JAX does (`fused_trunk='off'`). The program
runs on the card unless `--device cpu` is given; an artifact exported on
the CPU holds the plain operations (the kernels run on CUDA tensors only).
"""

from __future__ import annotations

import os
import time

from refnerf_tpu_torch.cli import flags


def _arguments(parser):
  parser.add_argument('--out', required=True, help='Output .rnsrv path.')
  parser.add_argument('--chunk', type=int, default=8192,
                      help='Rays per serving call (static).')
  parser.add_argument('--extras', action='store_true',
                      help='Include the full extras buffers.')
  parser.add_argument('--step', type=int, default=-1,
                      help='Checkpoint step (-1 = newest).')
  parser.add_argument('--fused', default='on', choices=('on', 'off'),
                      help="The trunks' fused_trunk mode in the program.")


def main(argv=None):
  config, gin, args = flags.load_config(argv, __doc__, None, False,
                                        _arguments)
  for mlp in ('NerfMLP', 'PropMLP'):
    gin.parse_line(f"{mlp}.fused_trunk = '{args.fused}'")

  from refnerf_tpu_torch import serving
  from refnerf_tpu_torch.models import construct
  from refnerf_tpu_torch.train import checkpoints as ckpt_lib
  from refnerf_tpu_torch.train import step as step_lib

  model = construct.construct_model(config, gin, args.device)
  state = step_lib.create_train_state(config, model)
  mgr = ckpt_lib.CheckpointManager(ckpt_lib.checkpoint_dir(config))
  state = mgr.restore(state, step=None if args.step < 0 else args.step)
  print(f'Restored step {int(state.step)} from '
        f'{ckpt_lib.checkpoint_dir(config)}')
  t0 = time.perf_counter()
  meta = serving.export_serving(
      model, args.out, chunk=args.chunk, device=args.device,
      compute_extras=args.extras, near=config.near, far=config.far)
  print(f'Wrote {args.out} ({os.path.getsize(args.out)} bytes, '
        f'{time.perf_counter() - t0:.1f} s): {meta}')
  return meta


if __name__ == '__main__':
  main()

"""End-to-end quality check: train Ref-NeRF on an analytic sphere scene and
report held-out PSNR (counterpart of tools/quality_check.py).

A healthy implementation exceeds ~25 dB within a few thousand steps;
failures in sampling, IPE, compositing or the loss stack show up as a
plateau. The scene is written by `tools/sphere_scene.py` where it is not on
disk yet: `sphere` is the diffuse Lambertian sphere, `shiny` the glossy one
under the analytic environment (view-dependent specular: the Ref-NeRF
check). Training runs through `NeRFSystem.train`, then `validate` renders
the held-out views.

    python3 -m refnerf_tpu_torch.tools.quality_check [--steps 3000] \
        [--scene-kind sphere|shiny] [--gin blender_refnerf.gin] [--f32] \
        [--fused auto|on|off] [--bindings 'Config.x = y'] [--device cuda]

Prints JAX's `QUALITY_CHECK steps=... train_time=...s heldout_psnr=...`
line, followed by the held-out SSIM and the train time over the steps in
ms (the first step's kernel build and the final validation and checkpoint
included; the train loop's own lines give the steady rate). The merged
config is written beside the logs, as the train CLI writes it
(`<out>/logs/sphere/sphere_quality/config.gin`), for the tools that read
the checkpoint (`eval_ckpt_step`, `extract_mesh`,
`export_torch_checkpoint`). The model runs on the card unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'configs')


class _Recorder:
  """A MetricHarness that keeps every metric dict it returns."""

  def __init__(self, harness):
    self.harness = harness
    self.scores = []

  def __call__(self, *args, **kwargs):
    out = self.harness(*args, **kwargs)
    self.scores.append(out)
    return out


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--steps', type=int, default=3000)
  p.add_argument('--out', default=None,
                 help='checkpoint directory (default: <tmp>/quality_check)')
  p.add_argument('--scene', default=None,
                 help='scene dir (default: <tmp>/<kind>_scene)')
  p.add_argument('--scene-kind', choices=['sphere', 'shiny'],
                 default='sphere',
                 help='sphere = diffuse Lambertian; shiny = glossy sphere '
                      'under an analytic environment (view-dependent '
                      'specular - the Ref-NeRF capability check)')
  p.add_argument('--gin', default='blender_refnerf.gin',
                 help='config under configs/ (e.g. blender_mipnerf.gin '
                      'for the no-reflection ablation)')
  p.add_argument('--res', type=int, default=64)
  p.add_argument('--bf16', action='store_true', default=True)
  p.add_argument('--f32', action='store_true',
                 help='override --bf16: run the trunks in float32')
  p.add_argument('--fused', choices=['auto', 'on', 'off'], default='auto',
                 help='NerfMLP.fused_trunk (A/B the CUDA kernels)')
  p.add_argument('--bindings', action='append', default=[],
                 help='extra gin bindings, applied last (win over the '
                      'built-in ones), e.g. "Config.n_input_views = 4"')
  p.add_argument('--device', default='cuda',
                 help="device of the model ('cuda' or 'cpu')")
  return p.parse_args(argv)


def bindings(args):
  """The gin bindings of the check (tools/quality_check.py:58-71)."""
  out = [
      f"Config.data_dir = '{args.scene}'",
      f"Config.checkpoint_dir = '{args.out}'",
      "Config.exp_name = 'sphere_quality'",
      'Config.batch_size = 1024',
      'Config.render_chunk_size = 4096',
      f'Config.max_steps = {args.steps}',
      f'Config.checkpoint_every = {args.steps}',
      'Config.print_every = 500',
      'Config.val_sample_num = 4',
      'Config.sample_noise_size = 0',
      # Short-run LR schedule (the 300k-step schedule barely decays here).
      'Config.lr_delay_steps = 512',
  ]
  if args.bf16 and not args.f32:
    out.append("NerfMLP.compute_dtype = 'bfloat16'")
  out.append(f"NerfMLP.fused_trunk = '{args.fused}'")
  out.extend(args.bindings)
  return out


def main(argv=None):
  args = parse_args(argv)
  from refnerf_tpu_torch import configs as configs_lib
  from refnerf_tpu_torch.system import NeRFSystem
  from refnerf_tpu_torch.tools import sphere_scene

  tmp = tempfile.gettempdir()
  if args.scene is None:
    args.scene = os.path.join(tmp, f'{args.scene_kind}_scene')
  if args.out is None:
    args.out = os.path.join(tmp, 'quality_check')
  if not os.path.exists(os.path.join(args.scene, 'transforms_train.json')):
    make = (sphere_scene.make_shiny_scene if args.scene_kind == 'shiny'
            else sphere_scene.make_scene)
    make(args.scene, res=args.res)

  # The merged config goes to <out>/logs/sphere/sphere_quality/config.gin,
  # the gin the eval, mesh and export tools take for this checkpoint.
  config, gin = configs_lib.load_config([os.path.join(_CONFIGS, args.gin)],
                                        bindings(args))
  system = NeRFSystem(config, gin, device=args.device)
  t0 = time.time()
  system.train()
  train_time = time.time() - t0
  system.metric_harness = recorder = _Recorder(system.metric_harness)
  psnr = system.validate(step=args.steps)
  ssim = sum(m['ssim'] for m in recorder.scores) / len(recorder.scores)
  print(f'QUALITY_CHECK steps={args.steps} train_time={train_time:.0f}s '
        f'heldout_psnr={psnr:.2f} heldout_ssim={ssim:.4f} '
        f'ms_per_step={1e3 * train_time / args.steps:.2f}')
  return psnr


if __name__ == '__main__':
  main()

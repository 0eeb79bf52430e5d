"""The training, eval and render orchestrator (counterpart of
refnerf_tpu/system.py:67-662).

`NeRFSystem(config, gin, summary_writer=None, device='cuda')` builds the
model on `device` (the card unless the caller names another; without a GPU
the default raises, as `construct_model` does) and runs one loop around the
port's train step:

  - the train split's batches come from `prefetch.training_batches`; rays
    are cast inside the step;
  - stats (per-loss values, per-parameter weight and gradient norms under
    the JAX package's parameter names, psnr, rays/s, the preemption-robust
    timed psnr) go to the host only every `print_every` steps, to the
    console and to TensorBoard;
  - every `checkpoint_every` steps: full-image validation renders at
    `train_frac(step)` -> `val/psnr` -> a checkpoint (top-k on val psnr and
    the latest; `train/checkpoints.py`);
  - the test loop: renders at `step / max_steps`, colour correction,
    quantized and cropped PSNR/SSIM(/LPIPS), the disparity and normal
    metrics, and the render_times.txt / metric_*.txt / avg_metrics.txt and
    image dumps;
  - path rendering: resumable, strided over jobs, per-buffer image dumps and
    the videos.

Under data parallelism (`group`, from parallel.mesh.initialize_distributed
under torchrun; JAX builds its mesh at :176) every rank holds the model on
its own device and steps on its rows of the global batch through
parallel/shard_step.py; the state starts as rank 0's (mesh.replicate);
rank 0 alone prints, writes the summaries, the metric files, the frames and
the checkpoints (rays/s counted over the global batch); the val, test and
path renders split each chunk across the ranks where `render_chunk_size`
divides across them, and are rendered by rank 0 alone otherwise (warned
once, as JAX does at :207-225).

Not ported: the XLA compile cache (JAX :48; there is no XLA here).
"""

from __future__ import annotations

import glob
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from refnerf_tpu_torch import metrics as metrics_lib
from refnerf_tpu_torch import vis as vis_lib
from refnerf_tpu_torch.cameras import camera_utils
from refnerf_tpu_torch.data import datasets as datasets_lib
from refnerf_tpu_torch.data import prefetch as prefetch_lib
from refnerf_tpu_torch.models import construct as construct_lib
from refnerf_tpu_torch.models import renderer as renderer_lib
from refnerf_tpu_torch.ops import image as image_ops
from refnerf_tpu_torch.ops import ref_utils
from refnerf_tpu_torch.parallel import mesh as mesh_lib
from refnerf_tpu_torch.parallel import shard_step
from refnerf_tpu_torch.train import checkpoints as ckpt_lib
from refnerf_tpu_torch.train import step as step_lib
from refnerf_tpu_torch.utils import io as io_lib
from refnerf_tpu_torch.utils import profiling

TIME_PRECISION = 1000  # integer milliseconds, for preemption-robust timing


class _FramePipeline:
  """Single-worker ordered pipeline for per-frame host post-processing.

  The eval/render loops queue a frame's render on the card and then spend
  seconds per frame on host work (color_correct, metrics, PNG/TIFF saves).
  Submitting that work here overlaps it with the next frame's render; one
  worker keeps execution in submission order (so metric lists, showcase
  labels, and per-frame prints stay sequential), and a bounded number of
  in-flight frames caps memory at ~2 frames of buffers.
  """

  def __init__(self, max_pending=2):
    import concurrent.futures
    self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    self._futures = []
    self._collected = 0  # futures [0, _collected) have been waited on
    self._max_pending = max_pending

  def submit(self, fn, *args):
    # Backpressure: wait on the OLDEST unwaited future (never a scan for a
    # not-done one: the worker can finish everything between a pending
    # count and a scan). result() is idempotent and returns at once when
    # done.
    while len(self._futures) - self._collected >= self._max_pending:
      self._futures[self._collected].result()
      self._collected += 1
    self._futures.append(self._pool.submit(fn, *args))

  def results(self):
    """Wait for everything; return per-frame results in submission order.

    Raises the first worker exception, like the serial loop would.
    """
    out = [f.result() for f in self._futures]
    self._pool.shutdown()
    return out


class _BatchLookahead:
  """One-ahead ray-batch builder on a worker thread.

  Building a full-image ray batch (the camera cast over every pixel, plus
  the ground-truth gather) costs host time per frame; done inline it sits
  between two renders. This iterator runs the builder on a single worker
  thread, one frame ahead of consumption. One worker and a depth-1
  lookahead keep the order (the builders may be stateful, e.g.
  `next(dataset)`) and bound the extra memory to one batch in flight.
  """

  def __init__(self, make_batch, keys, depth: int = 1):
    import collections
    import concurrent.futures
    self._fn = make_batch
    self._keys = iter(keys)
    self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    self._pending = collections.deque()
    for _ in range(depth + 1):
      self._advance()

  def _advance(self):
    try:
      key = next(self._keys)
    except StopIteration:
      return
    self._pending.append(self._pool.submit(self._fn, key))

  def __iter__(self):
    return self

  def __next__(self):
    if not self._pending:
      self._pool.shutdown()
      raise StopIteration
    fut = self._pending.popleft()
    try:
      out = fut.result()
    except Exception:
      self._pool.shutdown(wait=False)
      raise
    self._advance()
    return out


def _jax_name(name):
  """A parameter's name in the JAX package: 'nerf_mlp.spatial_0.weight' ->
  'nerf_mlp/spatial_0/kernel' (names without a dot pass unchanged)."""
  parts = name.split('.')
  if len(parts) > 1 and parts[-1] == 'weight':
    parts[-1] = 'kernel'
  return '/'.join(parts)


def _to_host(tree):
  """Stats (dicts of tensors) as dicts of numpy arrays."""
  if isinstance(tree, dict):
    return {_jax_name(k): _to_host(v) for k, v in tree.items()}
  if isinstance(tree, torch.Tensor):
    return tree.detach().cpu().numpy()
  return np.asarray(tree)


def _flatten_stats(stats, prefix=''):
  out = {}
  for k, v in stats.items():
    key = f'{prefix}/{k}' if prefix else k
    if isinstance(v, dict):
      out.update(_flatten_stats(v, key))
    else:
      out[key] = np.asarray(v)
  return out


def _levels(bundle):
  """A 'ray_' bundle (one tensor a level) as numpy: one array over the
  levels, as JAX stacks it, or the list of levels where their sample
  counts differ (64, 64, 32 in mip-NeRF 360's cascade), which JAX's
  np.asarray refuses (ROADMAP F10)."""
  levels = [np.asarray(level) for level in bundle]
  if len({a.shape for a in levels}) == 1:
    return np.asarray(levels)
  return levels


def _host_rendering(rendering):
  """render_image's dict as numpy: buffers in float64, and each 'ray_'
  bundle by `_levels`."""
  out = {}
  for k, v in rendering.items():
    if k.startswith('ray_'):
      out[k] = _levels(v)
    else:
      out[k] = np.asarray(v, np.float64)
  return out


class NeRFSystem:
  """Builds and runs the full train/eval/render pipeline for one config."""

  def __init__(self, config, gin, summary_writer=None, device='cuda',
               group=None):
    self.config = config
    self.gin = gin
    self.summary_writer = summary_writer
    self.group = group
    self.first = mesh_lib.is_first(group)
    n_dev = mesh_lib.size(group)
    if config.batch_size % n_dev != 0:
      raise ValueError(
          f'batch_size {config.batch_size} must divide across '
          f'{n_dev} devices')
    self.model = construct_lib.construct_model(config, gin, device)
    self.device = next(self.model.parameters()).device
    if group is not None:
      mesh_lib.build_kernels(group, self.device)
    self.state = step_lib.create_train_state(config, self.model)
    self._warned_eval_split = False
    self.metric_harness = metrics_lib.MetricHarness(device=self.device)
    self.total_time = 0
    self.total_steps = 0

    self.train_dataset = None
    self.val_dataset = None

  # ------------------------------------------------------------------ setup

  def setup_datasets(self, train=True, val=True):
    if train and self.train_dataset is None:
      self.train_dataset = datasets_lib.load_dataset(
          'train', self.config.data_dir, self.config)
    if val and self.val_dataset is None:
      self.val_dataset = datasets_lib.load_dataset(
          'test', self.config.data_dir, self.config)

  def _raycast_fn(self):
    camtype = self.train_dataset.camtype
    return lambda cameras, pixels: camera_utils.cast_ray_batch(
        cameras, pixels, camtype)

  def _to_device(self, rays):
    return rays.map(lambda x: x.to(self.device))

  def train_frac(self, step):
    return float(np.clip((step - 1) / (self.config.max_steps - 1), 0, 1))

  def _log(self, msg):
    if self.first:
      print(msg)

  def _render_group(self):
    """The group the eval and path renders split each chunk across: ours
    where render_chunk_size divides across the ranks, else None (rank 0
    renders alone; warned once)."""
    n = mesh_lib.size(self.group)
    if n == 1 or self.config.render_chunk_size % n == 0:
      return self.group
    if not self._warned_eval_split and self.first:
      self._warned_eval_split = True
      print(f'WARNING: render_chunk_size={self.config.render_chunk_size} '
            f'does not divide across the {n} ranks; eval/render frames fall '
            f'back to rank 0 alone. Set render_chunk_size to a multiple of '
            f'{n} to split frames across the ranks.', file=sys.stderr,
            flush=True)
    return None

  def _renders(self):
    """Whether this rank takes part in the eval and path renders."""
    return self.first or self._render_group() is not None

  # ------------------------------------------------------------------ train

  def train(self):
    """The main training loop."""
    config = self.config
    self.setup_datasets()

    ckpt_mgr = ckpt_lib.CheckpointManager(
        ckpt_lib.checkpoint_dir(config), save_top_k=config.save_top_k,
        group=self.group)
    # Rank 0's latest step decides for every rank, so that all of them
    # enter restore's collectives or none does.
    latest = mesh_lib.agree(ckpt_mgr.latest_step(), self.group)
    if config.resume_path or latest is not None:
      try:
        self.state = ckpt_mgr.restore(self.state, latest)
        self._log(f'Resumed from step {int(self.state.step)}')
      except FileNotFoundError:
        pass
    # Every rank starts from rank 0's state.
    mesh_lib.replicate(self.state, self.group)

    cameras = self.train_dataset.device_cameras(self.device)
    train_step = shard_step.make_sharded_train_step(
        self.model, config, self.group, raycast_fn=self._raycast_fn())
    # Align the stateless batch stream to the restored step: the sampler
    # reproduces the exact batch sequence an uninterrupted run would see.
    self.train_dataset.seek(int(self.state.step))
    batches = prefetch_lib.training_batches(
        self.train_dataset, device=self.device,
        rank=mesh_lib.rank(self.group), world_size=mesh_lib.size(self.group))

    num_params = sum(p.numel() for p in self.model.parameters())
    self._log(f'Training with {num_params} parameters, '
              f'batch size {config.batch_size}')

    first_step = int(self.state.step)
    max_steps = config.max_steps
    if config.early_exit_steps is not None:
      max_steps = min(max_steps, config.early_exit_steps)

    tracer = profiling.StepTracer()
    try:
      self._train_loop(batches, train_step, cameras, first_step, max_steps,
                       num_params, ckpt_mgr, tracer)
    finally:
      batches.close()
    tracer.close()

  def _train_loop(self, batches, train_step, cameras, first_step, max_steps,
                  num_params, ckpt_mgr, tracer):
    config = self.config
    stats_buffer = []
    train_start_time = time.time()
    for step in range(first_step, max_steps):
      tracer.step(step)
      batch = next(batches)
      self.state, stats = train_step(self.state, batch, cameras)
      if self.first:
        stats_buffer.append(stats)

      if self.first and (step == first_step or
                         (step + 1) % config.print_every == 0):
        # Pull stats to host only at summary boundaries, on rank 0.
        stats_buffer = [_to_host(s) for s in stats_buffer]
        elapsed = time.time() - train_start_time
        steps_per_sec = len(stats_buffer) / elapsed
        rays_per_sec = config.batch_size * steps_per_sec

        self.total_time += int(round(TIME_PRECISION * elapsed))
        self.total_steps += len(stats_buffer)
        approx_total_time = int(round(
            step * self.total_time / max(1, self.total_steps)))

        if self.summary_writer is not None:
          self._write_train_summaries(
              step, stats_buffer, steps_per_sec, rays_per_sec, num_params,
              approx_total_time)
        last = _flatten_stats(stats_buffer[-1])
        print(f'step {step + 1}/{max_steps}: '
              f"loss={float(last['loss']):.5f} "
              f"psnr={float(last['psnr']):.3f} "
              f'{steps_per_sec:.2f} steps/s {rays_per_sec:.0f} rays/s')
        stats_buffer = []
        train_start_time = time.time()

      if (step + 1) % config.checkpoint_every == 0 or step + 1 == max_steps:
        val_psnr = self.validate(step + 1)
        ckpt_mgr.save(step + 1, self.state, val_psnr=val_psnr)
        train_start_time = time.time()

  def _write_train_summaries(self, step, stats_buffer, steps_per_sec,
                             rays_per_sec, num_params, approx_total_time):
    w = self.summary_writer
    fs = [_flatten_stats(s) for s in stats_buffer]
    stats_stacked = {k: np.stack([f[k] for f in fs]) for k in fs[0]}
    stats_split = {}
    for k, v in stats_stacked.items():
      if v.ndim == 1:
        stats_split[k] = v
      elif v.ndim == 2:
        for i in range(v.shape[1]):
          stats_split[f'{k}/{i}'] = v[:, i]
    for k, v in stats_split.items():
      w.add_histogram('train/' + k, v, step)
      w.add_scalar(f'train/avg_{k}', float(np.mean(v)), step)
      w.add_scalar(f'train/max_{k}', float(np.max(v)), step)
    w.add_scalar('train/num_params', num_params, step)
    w.add_scalar('train/steps_per_sec', steps_per_sec, step)
    w.add_scalar('train/rays_per_sec', rays_per_sec, step)
    avg_psnr = float(np.mean(stats_split['psnr']))
    w.add_scalar('train/avg_psnr_timed', avg_psnr,
                 self.total_time // TIME_PRECISION)
    w.add_scalar('train/avg_psnr_timed_approx', avg_psnr,
                 approx_total_time // TIME_PRECISION)

  # ------------------------------------------------------------------ val

  def validate(self, step) -> float:
    """Render val images at train_frac(step), log panels, return the mean
    PSNR (0 on a rank that takes no part in the renders)."""
    config = self.config
    self.setup_datasets()
    if not self._renders():
      return 0.0
    group = self._render_group()
    writer = self.summary_writer if self.first else None

    psnrs = []
    n = min(config.val_sample_num, self.val_dataset.size)
    for _ in range(n):
      batch = next(self.val_dataset)
      eval_start = time.time()
      rendering = renderer_lib.render_image(
          self.model, self._to_device(batch.rays), config.render_chunk_size,
          compute_extras=True, vis_num_rays=config.vis_num_rays,
          train_frac=self.train_frac(step), group=group)
      eval_time = time.time() - eval_start
      num_rays = int(np.prod(batch.rays.shape))

      rgb = rendering['rgb']
      if config.supervised_by_linear_rgb:
        rgb = image_ops.linear_to_srgb(rgb)
      metric = self.metric_harness(rgb, batch.rgb)
      psnr = metric['psnr']
      psnrs.append(0.0 if np.isnan(psnr) else psnr)

      if writer is not None:
        writer.add_scalar('val/rays_per_sec', num_rays / eval_time, step)
        vis_suite = vis_lib.visualize_suite(
            _host_rendering(rendering), batch.rays,
            config.supervised_by_linear_rgb)
        # Optionally decimate TB images to conserve event-file size.
        dec = max(config.vis_decimate, 1)
        decimate = lambda x: x[::dec, ::dec] if dec > 1 else x
        writer.add_image(
            'val/true_color', decimate(np.asarray(batch.rgb)), step,
            dataformats='HWC')
        if batch.normals is not None:
          writer.add_image(
              'val/true_normals',
              decimate(np.asarray(batch.normals)) / 2.0 + 0.5, step,
              dataformats='HWC')
        for k, v in vis_suite.items():
          writer.add_image(
              'val/output_' + k, decimate(v), step,
              dataformats='HWC' if v.ndim == 3 else 'HW')

    mean_psnr = float(np.mean(psnrs)) if psnrs else 0.0
    if writer is not None:
      writer.add_scalar('val/psnr', mean_psnr, step)
    self._log(f'validation @ step {step}: psnr={mean_psnr:.3f}')
    return mean_psnr

  # ------------------------------------------------------------------ test

  def test(self, step: Optional[int] = None):
    """Full test-set evaluation with color correction and metric dumps
    (rank 0's; [] on the other ranks)."""
    config = self.config
    self.setup_datasets(train=False)
    if not self._renders():
      return []
    group = self._render_group()
    self.metric_harness = metrics_lib.MetricHarness(compute_lpips=True,
                                                    device=self.device)
    step = step if step is not None else int(self.state.step)
    train_frac = step / config.max_steps

    out_dir = os.path.join(
        ckpt_lib.checkpoint_dir(config),
        'path_renders' if config.render_path else 'test_preds')
    if config.eval_save_output and self.first:
      os.makedirs(out_dir, exist_ok=True)
    path_fn = lambda x: os.path.join(out_dir, x)

    metrics, metrics_cc, render_times, showcases = [], [], [], []
    num_eval = min(self.val_dataset.size, config.eval_dataset_limit)
    # Showcase selection (refnerf-pl nerf_system.py:329-334): a seeded
    # permutation picks num_showcase_images eval views whose panel suites
    # are logged to TensorBoard (and whose ray bundles are dumped under
    # eval_save_ray_data).
    perm = np.random.RandomState(config.seed).permutation(num_eval)
    showcase_indices = set(
        np.sort(perm[:config.num_showcase_images]).tolist())

    last_done = [0.0]  # worker-only state; the single worker keeps it ordered

    def postprocess(idx, finish, batch, eval_start):
      """Everything after the render is queued for one frame: the copy to
      the host and merge, color correction, metrics, showcase collection,
      image dumps. Runs on the pipeline worker, overlapped with the next
      frame's render."""
      rendering = finish()
      # Exclusive per-frame time: frames are queued back-to-back, so
      # queue->merge latency would double-count the wait behind the
      # previous frame. Clock from whichever is later: this frame's own
      # start or the previous frame's completion.
      done = time.time()
      render_time = done - max(eval_start, last_done[0])
      last_done[0] = done
      render_times.append(render_time)
      ray_bundle = {k: _levels(v) for k, v in rendering.items()
                    if k.startswith('ray_')}
      rendering = {k: np.asarray(v, np.float64)
                   for k, v in rendering.items() if not k.startswith('ray_')}
      metric = metric_cc = None
      if not config.render_path:  # a path has no ground truth
        metric, metric_cc, rgb_cc = metrics_lib.eval_metrics(
            self.metric_harness, rendering['rgb'], batch.rgb, config)
        rendering['rgb_cc'] = rgb_cc.cpu().numpy()

      if idx in showcase_indices:
        # deterministic_showcase labels panels by dataset index; otherwise
        # by collection order (refnerf-pl nerf_system.py:400-403).
        label = idx if config.deterministic_showcase else len(showcases)
        showcases.append((label, {**rendering, **ray_bundle}, batch))
      if not config.render_path:
        if config.compute_disp_metrics and batch.disps is not None:
          for tag in ['mean', 'median']:
            key = f'distance_{tag}'
            if key in rendering:
              disparity = 1 / (1 + rendering[key])
              metric[f'disparity_{tag}_mse'] = float(
                  ((disparity - np.asarray(batch.disps)) ** 2).mean())

        if config.compute_normal_metrics and batch.normals is not None:
          f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
          weights = f32(rendering['acc'] * np.asarray(batch.alphas))
          norm_gt = ref_utils.l2_normalize(f32(batch.normals))
          for key, val in rendering.items():
            if key.startswith('normals') and val is not None:
              norm = ref_utils.l2_normalize(f32(val))
              metric[key + '_mae'] = float(ref_utils.compute_weighted_mae(
                  weights, norm, norm_gt))

        print(f"eval {idx + 1}/{num_eval}: psnr={metric['psnr']:.3f} "
              f'time={render_time:.2f}s')

      if config.eval_save_output and config.eval_render_interval > 0:
        if idx % config.eval_render_interval == 0:
          io_lib.save_img_u8(rendering['rgb'], path_fn(f'color_{idx:03d}.png'))
          if 'rgb_cc' in rendering:
            io_lib.save_img_u8(rendering['rgb_cc'],
                               path_fn(f'color_cc_{idx:03d}.png'))
          for key in ['distance_mean', 'distance_median']:
            if key in rendering:
              io_lib.save_img_f32(rendering[key],
                                  path_fn(f'{key}_{idx:03d}.tiff'))
          for key in ['normals_pred']:
            if key in rendering:
              io_lib.save_img_u8(rendering[key] / 2.0 + 0.5,
                                 path_fn(f'{key}_{idx:03d}.png'))
          io_lib.save_img_f32(rendering['acc'], path_fn(f'acc_{idx:03d}.tiff'))
      return metric, metric_cc

    pipeline = _FramePipeline()
    batches = _BatchLookahead(
        lambda _: next(self.val_dataset), range(num_eval))
    for idx, batch in enumerate(batches):
      eval_start = time.time()
      finish = renderer_lib.render_image(
          self.model, self._to_device(batch.rays), config.render_chunk_size,
          compute_extras=True, vis_num_rays=config.vis_num_rays,
          fetch=False, train_frac=train_frac, group=group)
      if self.first:
        pipeline.submit(postprocess, idx, finish, batch, eval_start)

    for metric, metric_cc in pipeline.results():
      if metric is not None:
        metrics.append(metric)
        metrics_cc.append(metric_cc)

    if config.eval_save_output and not config.render_path and metrics:
      with open(path_fn('render_times.txt'), 'w') as f:
        f.write(' '.join(str(r) for r in render_times))
      for name in metrics[0]:
        with open(path_fn(f'metric_{name}.txt'), 'w') as f:
          f.write(' '.join(str(m[name]) for m in metrics))
      for name in metrics_cc[0]:
        with open(path_fn(f'metric_cc_{name}.txt'), 'w') as f:
          f.write(' '.join(str(m[name]) for m in metrics_cc))
      if config.eval_save_ray_data:
        for i, r, b in showcases:
          rays = {k: v for k, v in r.items() if 'ray_' in k}
          np.set_printoptions(threshold=sys.maxsize)
          with open(path_fn(f'ray_data_{i}.txt'), 'w') as f:
            f.write(repr(rays))
      with open(path_fn('avg_metrics.txt'), 'w') as f:
        f.write(f'render_time: {np.mean(render_times)}\n')
        for name in metrics[0]:
          f.write(f'{name}: {np.mean([m[name] for m in metrics])}\n')
        for name in metrics_cc[0]:
          f.write(f'cc_{name}: {np.mean([m[name] for m in metrics_cc])}\n')
        if self.metric_harness.lpips_fn is None:
          # A placeholder line instead of a silent omission: LPIPS is
          # missing until its weights are on disk (metrics.LPIPS_WEIGHTS_ENV).
          f.write('lpips: unavailable (no VGG weights; see '
                  'tools/convert_lpips_weights.py)\n')

    if (self.summary_writer is not None and self.first and
        not config.render_path):
      dec = max(config.vis_decimate, 1)
      decimate = lambda x: x[::dec, ::dec] if dec > 1 else x
      for label, rendering, batch in showcases:
        suite = vis_lib.visualize_suite(
            rendering, batch.rays, config.supervised_by_linear_rgb)
        for k, v in suite.items():
          self.summary_writer.add_image(
              f'test/showcase_{label}_{k}',
              decimate(np.asarray(v, np.float32)), step,
              dataformats='HWC' if v.ndim == 3 else 'HW')
    return metrics

  # ------------------------------------------------------------------ render

  def render(self, dataset, base_dir, out_dir, out_name):
    """Resumable, multi-job-strided path rendering + video assembly
    (refnerf-pl nerf_system.py:467-537). Returns the video writer that
    served each tag (empty until every frame exists, and on every rank but
    0)."""
    config = self.config
    if not self._renders():
      return {}
    group = self._render_group()
    zpad = max(3, len(str(dataset.size - 1)))
    path_fn = lambda x: os.path.join(out_dir, x)
    idx_to_str = lambda idx: str(idx).zfill(zpad)
    os.makedirs(out_dir, exist_ok=True)

    last_done = [0.0]  # worker-only state (exclusive-time clock, see test())

    def save_frame(idx_str, finish, eval_start, idx):
      """Per-frame copy to the host and buffer dumps, overlapped with the
      next frame's render."""
      rendering = finish()
      done = time.time()
      print(f'Rendered {idx + 1}/{dataset.size} '
            f'in {done - max(eval_start, last_done[0]):0.3f}s')
      last_done[0] = done
      rendering = {k: np.asarray(v, np.float64)
                   for k, v in rendering.items()
                   if k in ['rgb', 'diffuse', 'specular', 'normals_pred',
                            'acc', 'distance_mean', 'distance_median',
                            'roughness']}
      io_lib.save_img_u8(rendering['rgb'], path_fn(f'color_{idx_str}.png'))
      io_lib.save_img_u8(rendering['diffuse'],
                         path_fn(f'diffuse_{idx_str}.png'))
      io_lib.save_img_u8(rendering['specular'],
                         path_fn(f'specular_{idx_str}.png'))
      if 'normals_pred' in rendering:
        io_lib.save_img_u8(rendering['normals_pred'] / 2.0 + 0.5,
                           path_fn(f'normals_pred_{idx_str}.png'))
      io_lib.save_img_f32(rendering['distance_mean'],
                          path_fn(f'distance_mean_{idx_str}.tiff'))
      io_lib.save_img_f32(rendering['distance_median'],
                          path_fn(f'distance_median_{idx_str}.tiff'))
      io_lib.save_img_f32(rendering['acc'], path_fn(f'acc_{idx_str}.tiff'))
      if 'roughness' in rendering:
        io_lib.save_img_u8(rendering['roughness'],
                           path_fn(f'rho_{idx_str}.png'),
                           mask=rendering['acc'])

    todo = []
    for idx in range(dataset.size):
      if idx % config.render_num_jobs != config.render_job_id:
        continue
      # Resume: a frame counts as done only when the NEXT one exists too
      # (its presence proves this one finished writing before the
      # interruption), as the reference's strided-resume check does.
      curr_file = path_fn(f'color_{idx_to_str(idx)}.png')
      next_file = path_fn(
          f'color_{idx_to_str(idx + config.render_num_jobs)}.png')
      if os.path.exists(curr_file) and os.path.exists(next_file):
        self._log(f'Image {idx}/{dataset.size} already exists, skipping')
        continue
      todo.append(idx)

    pipeline = _FramePipeline()
    batches = _BatchLookahead(dataset.generate_ray_batch, todo)
    for idx, batch in zip(todo, batches):
      idx_str = idx_to_str(idx)
      self._log(f'Evaluating image {idx + 1}/{dataset.size}')
      eval_start = time.time()
      finish = renderer_lib.render_image(
          self.model, self._to_device(batch.rays), config.render_chunk_size,
          compute_extras=True, vis_num_rays=config.vis_num_rays, fetch=False,
          group=group)
      if self.first:
        pipeline.submit(save_frame, idx_str, finish, eval_start, idx)

    pipeline.results()  # flush saves before counting files for the video
    if not self.first:
      return {}
    num_files = len(glob.glob(path_fn('acc_*.tiff')))
    if num_files == dataset.size:
      print(f'All files found, creating videos '
            f'(job {config.render_job_id}).')
      return vis_lib.create_videos(config, base_dir, out_dir, out_name,
                                   dataset.size)
    return {}

  # ------------------------------------------------------------------ ckpt

  def restore_latest(self):
    mgr = ckpt_lib.CheckpointManager(
        ckpt_lib.checkpoint_dir(self.config),
        save_top_k=self.config.save_top_k, group=self.group)
    self.state = mgr.restore(self.state)
    return int(self.state.step)

"""Tracing and timing hooks (counterpart of refnerf_tpu/utils/profiling.py).

Set REFNERF_TPU_PROFILE_DIR=/tmp/trace to record train steps
[TRACE_START_STEP, TRACE_START_STEP + TRACE_NUM_STEPS) with torch.profiler
(the host and, on the card, CUDA activity) and export them there as a Chrome
trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import os
import re
import time

import torch

PROFILE_DIR_ENV = 'REFNERF_TPU_PROFILE_DIR'
# Capture window (steps) when env-driven profiling is on.
TRACE_START_STEP = 10
TRACE_NUM_STEPS = 5


class StepTracer:
  """Env-driven trace of steps [TRACE_START_STEP, +TRACE_NUM_STEPS)."""

  def __init__(self):
    self.log_dir = os.environ.get(PROFILE_DIR_ENV)
    self._prof = None

  def step(self, step: int):
    if not self.log_dir:
      return
    if step == TRACE_START_STEP and self._prof is None:
      activities = [torch.profiler.ProfilerActivity.CPU]
      if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
      self._prof = torch.profiler.profile(activities=activities)
      self._prof.__enter__()
    elif step == TRACE_START_STEP + TRACE_NUM_STEPS and self._prof is not None:
      self._stop()

  def _stop(self):
    if torch.cuda.is_available():
      torch.cuda.synchronize()
    self._prof.__exit__(None, None, None)
    os.makedirs(self.log_dir, exist_ok=True)
    path = os.path.join(
        self.log_dir, f'steps_{TRACE_START_STEP}-'
        f'{TRACE_START_STEP + TRACE_NUM_STEPS - 1}.trace.json')
    self._prof.export_chrome_trace(path)
    self._prof = None
    print(f'Wrote torch.profiler trace to {path}')

  def close(self):
    if self._prof is not None:
      self._stop()


class Timer:
  """Tiny scoped wall-clock timer for host-side phases."""

  def __init__(self, name: str, verbose: bool = True):
    self.name = name
    self.verbose = verbose

  def __enter__(self):
    self.t0 = time.perf_counter()
    return self

  def __exit__(self, *exc):
    self.elapsed = time.perf_counter() - self.t0
    if self.verbose:
      print(f'[{self.name}] {self.elapsed:.3f}s')


# The trunk kernels of csrc/, by their CUDA names: the forwards and the
# per-tile backwards, each a category of its own in `device_split`.
TRUNK_KERNELS = ('trunk_fwd_tma_kernel', 'trunk_fwd_f32_kernel',
                 'trunk_fwd_kernel', 'trunk_bwd_tma_kernel',
                 'trunk_bwd_f32_kernel', 'trunk_bwd_kernel')
WGRAD = 'weight gradients and reductions'  # wgrad*_kernel, reduce_kernel
OTHER = 'other kernels'
COPIES = 'copies'


def kernel_category(name: str) -> str:
  """The category of a device event's name in `device_split`."""
  if 'Memcpy' in name or 'Memset' in name:
    return COPIES
  # The function's own name, without return type, namespace, template or
  # parameters: trunk_fwd_kernel must not match trunk_fwd_tma_kernel.
  words = re.split(r'[<(]', name.replace('(anonymous namespace)::', ''))[0]
  base = words.split('::')[-1].split()[-1] if words.split() else ''
  if base in TRUNK_KERNELS:
    return base
  if 'wgrad' in name or 'reduce_kernel' in name:
    return WGRAD
  return OTHER


def device_split(prof, wall_s: float, calls: int = 1):
  """Device time of a torch.profiler window by category, ms a call: each
  trunk kernel of TRUNK_KERNELS, WGRAD, OTHER and COPIES; with 'busy' (their
  sum), 'wall' (`wall_s` a call: time as many calls outside the profiler,
  whose host cost lengthens the traced window), 'idle share' (1 - busy /
  wall) and 'launches' (device events a call). Without device events busy
  is 0 and the idle share None."""
  split = {k: 0.0 for k in TRUNK_KERNELS + (WGRAD, OTHER, COPIES)}
  launches = 0
  for e in prof.key_averages():
    if e.device_type != torch.autograd.DeviceType.CUDA:
      continue
    us = getattr(e, 'self_device_time_total',
                 getattr(e, 'self_cuda_time_total', 0))
    split[kernel_category(e.key)] += us / 1e3 / calls
    launches += e.count
  busy = sum(split.values())
  wall = wall_s * 1e3 / calls
  return {**split, 'busy': busy, 'wall': wall,
          'idle share': (1 - busy / wall) if busy > 0 else None,
          'launches': launches / calls}

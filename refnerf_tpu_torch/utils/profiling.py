"""Tracing and timing hooks (counterpart of refnerf_tpu/utils/profiling.py).

Set REFNERF_TPU_PROFILE_DIR=/tmp/trace to record train steps
[TRACE_START_STEP, TRACE_START_STEP + TRACE_NUM_STEPS) with torch.profiler
(the host and, on the card, CUDA activity) and export them there as a Chrome
trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import os
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

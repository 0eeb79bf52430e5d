"""Checkpoints of the train state: top-k on val PSNR and the latest
(counterpart of refnerf_tpu/train/checkpoints.py, which writes orbax).

A checkpoint is `<dir>/<last|best>/<step>/state.pt`: `torch.save` of the
state's step, the model's `state_dict` and the Adam state (its integer
count, mu and nu), beside `metrics.json` in `best/`. `last/` keeps the newest step, for
resume; `best/` keeps the `save_top_k` steps of highest val PSNR, and a save
without a score goes to `last/` only (JAX :51-57). Each save is written into
a temporary directory and then moved into place with `os.replace`, so a
process killed mid-save leaves the earlier checkpoints readable (orbax's
finalize does the same); a leftover temporary directory is not a step and is
ignored.

Under data parallelism (`group`) the ranks hold the same state: rank 0
alone writes it, and every rank waits at a barrier after the save, so that
none reads or lists the directory while it is written. Every rank restores
the same file.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional

import torch

from refnerf_tpu_torch import configs as configs_lib
from refnerf_tpu_torch.parallel import mesh

_STATE = 'state.pt'
_METRICS = 'metrics.json'


def checkpoint_dir(config) -> str:
  """<ckpt>/ckpt/<exp-prefix>/<exp> (the JAX package's layout)."""
  return configs_lib.exp_dir(config, 'ckpt')


def _steps(directory):
  """The steps saved in `directory` (digit-named entries holding a state)."""
  return sorted(int(n) for n in os.listdir(directory)
                if n.isdigit() and
                os.path.exists(os.path.join(directory, n, _STATE)))


def _write(directory, step, payload, metrics=None):
  tmp = tempfile.mkdtemp(prefix=f'.tmp-{step}-', dir=directory)
  with open(os.path.join(tmp, _STATE), 'wb') as f:
    torch.save(payload, f)
    f.flush()
    os.fsync(f.fileno())
  if metrics is not None:
    with open(os.path.join(tmp, _METRICS), 'w') as f:
      json.dump(metrics, f)
  # Onto an existing step this raises (the directory is not empty), as
  # orbax refuses a step it already holds.
  os.replace(tmp, os.path.join(directory, str(step)))


class CheckpointManager:
  """Step-indexed train-state checkpoints: top-k by val PSNR in `best/`, and
  the latest in `last/`."""

  def __init__(self, directory: str, save_top_k: int = 5, group=None):
    self._group = group
    directory = os.path.abspath(directory)
    self._last = os.path.join(directory, 'last')
    self._best = os.path.join(directory, 'best')
    os.makedirs(self._last, exist_ok=True)
    os.makedirs(self._best, exist_ok=True)
    self._top_k = max(save_top_k, 1)

  def save(self, step: int, state, val_psnr: Optional[float] = None):
    """Save `state` (a train.step.TrainState) as `step`: on rank 0 of the
    group, the others waiting."""
    if mesh.is_first(self._group):
      self._save(step, state, val_psnr)
    mesh.barrier(self._group)

  def _save(self, step, state, val_psnr):
    payload = {
        'step': int(state.step),
        'model': {k: v.detach() for k, v in state.model.state_dict().items()},
        'count': int(state.opt.count),
        'mu': {k: v.detach() for k, v in state.opt.mu.items()},
        'nu': {k: v.detach() for k, v in state.opt.nu.items()}}
    _write(self._last, step, payload)
    for s in _steps(self._last):
      if s != step:
        shutil.rmtree(os.path.join(self._last, str(s)))
    if val_psnr is None:
      return
    _write(self._best, step, payload, {'val_psnr': float(val_psnr)})
    # Keep the top k by (score, step): among equal scores the newest stays.
    ranked = sorted(self._scores().items(), key=lambda kv: (kv[1], kv[0]))
    for s, _ in ranked[:-self._top_k]:
      shutil.rmtree(os.path.join(self._best, str(s)))

  def _scores(self):
    out = {}
    for s in _steps(self._best):
      with open(os.path.join(self._best, str(s), _METRICS)) as f:
        out[s] = json.load(f)['val_psnr']
    return out

  def latest_step(self) -> Optional[int]:
    steps = _steps(self._last) + _steps(self._best)
    return max(steps) if steps else None

  def best_step(self) -> Optional[int]:
    scores = self._scores()
    if not scores:
      return None
    return max(scores.items(), key=lambda kv: (kv[1], kv[0]))[0]

  def restore(self, state, step: Optional[int] = None):
    """Load a checkpoint (the latest by default) into `state` in place,
    onto the device of its model, and return it."""
    if step is None:
      step = self.latest_step()
    # Every rank restores the step rank 0 found.
    step = mesh.agree(step, self._group)
    if step is None:
      raise FileNotFoundError('No checkpoint found.')
    sub = self._last if step in _steps(self._last) else self._best
    path = os.path.join(sub, str(step), _STATE)
    if not os.path.exists(path):
      raise FileNotFoundError(f'No checkpoint found at step {step}.')
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload['model'])
    state.step = payload['step']
    state.opt.count = payload['count']
    state.opt.mu = payload['mu']
    state.opt.nu = payload['nu']
    return state

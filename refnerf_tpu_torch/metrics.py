"""Image-quality metrics: PSNR, SSIM, and LPIPS when its weights are on disk
(counterpart of refnerf_tpu/metrics.py:32-125).

The metrics run on the harness's device, the card unless the caller names
another (`device='cpu'`); without a GPU that default raises rather than
falling back to the CPU. Images on another device are copied to it. LPIPS
needs pretrained VGG16 features: with a weights file (npz; `LPIPS_WEIGHTS_ENV` or
an argument) a VGG16-LPIPS of plain `conv2d`s evaluates it; otherwise LPIPS
is skipped, with one warning a process.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from refnerf_tpu_torch.ops import image as image_ops

LPIPS_WEIGHTS_ENV = 'REFNERF_TPU_LPIPS_WEIGHTS'

# Warn once per process: a harness is built per eval call site, and the
# missing-weights warning would repeat.
_LPIPS_WARNED = [False]

_IMAGENET_MEAN = np.array([-0.030, -0.088, -0.188], np.float32)
_IMAGENET_STD = np.array([0.458, 0.448, 0.450], np.float32)


def _check_device(device) -> torch.device:
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        f'device {device} asked for, but no CUDA device is available; pass '
        "device='cpu' to compute the metrics on the CPU")
  return device


class VGGLPIPS:
  """LPIPS(VGG) from a weights archive.

  Expects an .npz containing VGG16 conv kernels/biases named
  `features_{i}_weight` / `features_{i}_bias` (torchvision layer indexing,
  OIHW) and LPIPS linear head weights `lin{k}_weight` [1, C, 1, 1]. Runs
  on `device`, the card unless the caller names another.
  """

  def __init__(self, weights_path: str, device='cuda'):
    device = _check_device(device)
    data = np.load(weights_path)
    # torchvision VGG16 conv layer indices; LPIPS taps the post-relu output
    # of the last conv in each block (relu1_2/2_2/3_3/4_3/5_3).
    self.conv_ids = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    self.block_end_convs = {2, 7, 14, 21, 28}
    put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    self.params = {}
    for cid in self.conv_ids:
      self.params[f'w{cid}'] = put(data[f'features_{cid}_weight'])
      self.params[f'b{cid}'] = put(data[f'features_{cid}_bias'])
    for k in range(5):
      self.params[f'lin{k}'] = put(data[f'lin{k}_weight'])  # [1, C, 1, 1]
    self.mean = put(_IMAGENET_MEAN)
    self.std = put(_IMAGENET_STD)

  def _features(self, x):
    """x: [H, W, 3] in [-1, 1] -> list of 5 unit-normalized feature maps."""
    x = ((x - self.mean) / self.std).permute(2, 0, 1)[None]  # NCHW
    feats = []
    for conv_id in self.conv_ids:
      x = F.relu(F.conv2d(x, self.params[f'w{conv_id}'],
                          self.params[f'b{conv_id}'], padding='same'))
      if conv_id in self.block_end_convs:
        # lpips.normalize_tensor: eps added to the norm, not the squared sum.
        norm = torch.sqrt(torch.sum(x**2, dim=1, keepdim=True))
        feats.append(x / (norm + 1e-10))
        if len(feats) < 5:
          x = F.max_pool2d(x, 2, 2)
    return feats

  @torch.no_grad()
  def __call__(self, img0, img1) -> float:
    """img0/img1: [H, W, 3] in [0, 1]."""
    dev = self.mean.device
    f0 = self._features(torch.as_tensor(img0, device=dev).float() * 2 - 1)
    f1 = self._features(torch.as_tensor(img1, device=dev).float() * 2 - 1)
    total = 0.0
    for k, (a, b) in enumerate(zip(f0, f1)):
      total = total + torch.mean(F.conv2d((a - b)**2, self.params[f'lin{k}']))
    return float(total)


class MetricHarness:
  """PSNR + SSIM (+ LPIPS when weights are provided), on `device`."""

  def __init__(self, compute_lpips: bool = False,
               lpips_weights: Optional[str] = None, device='cuda'):
    self.device = _check_device(device)
    self.ssim_fn = image_ops.ssim
    self.lpips_fn = None
    if compute_lpips:
      path = lpips_weights or os.environ.get(LPIPS_WEIGHTS_ENV)
      if path and os.path.exists(path):
        self.lpips_fn = VGGLPIPS(path, self.device)
      elif not _LPIPS_WARNED[0]:
        _LPIPS_WARNED[0] = True
        warnings.warn(
            'LPIPS requested but no weights found '
            f'(path={path!r}; set ${LPIPS_WEIGHTS_ENV}). Eval metrics will '
            'NOT include lpips. Provision the .npz with '
            'tools/convert_lpips_weights.py (see README "LPIPS weights").',
            stacklevel=2)

  @torch.no_grad()
  def __call__(self, rgb_pred, rgb_gt,
               name_fn: Callable[[str], str] = lambda s: s) -> Dict[str, float]:
    """PSNR and SSIM of [H, W, 3] images, in float32 on the harness's
    device."""
    rgb_pred = torch.as_tensor(rgb_pred).to(device=self.device,
                                            dtype=torch.float32)
    rgb_gt = torch.as_tensor(rgb_gt).to(device=self.device,
                                        dtype=torch.float32)
    psnr = float(image_ops.mse_to_psnr(torch.mean((rgb_pred - rgb_gt)**2)))
    ssim = float(self.ssim_fn(rgb_pred, rgb_gt))
    out = {name_fn('psnr'): psnr, name_fn('ssim'): ssim}
    if self.lpips_fn is not None:
      out[name_fn('lpips')] = self.lpips_fn(rgb_pred, rgb_gt)
    return out


def eval_metrics(harness: MetricHarness, rgb, rgb_gt, config):
  """The metrics of one rendered view, as the JAX eval loop takes them
  (system.py:458-479): the colour-corrected render (`ops.image.
  color_correct`, float64), both renders quantized to 8 bits under
  `Config.eval_quantize_metrics` and cropped by `Config.eval_crop_borders`,
  each against the ground truth. Runs on the harness's device. Returns
  (metrics of rgb, metrics of the colour-corrected rgb, the colour-corrected
  rgb, on the harness's device)."""
  rgb = torch.as_tensor(rgb).to(device=harness.device, dtype=torch.float64)
  rgb_gt = torch.as_tensor(rgb_gt).to(device=harness.device,
                                      dtype=torch.float64)
  rgb_cc = image_ops.color_correct(rgb, rgb_gt)
  a, a_cc, gt = rgb, rgb_cc, rgb_gt
  if config.eval_quantize_metrics:
    # Reported metrics must reproduce from the saved 8-bit PNGs.
    a, a_cc = (torch.round(x * 255) / 255 for x in (a, a_cc))
  if config.eval_crop_borders > 0:
    c = config.eval_crop_borders
    a, a_cc, gt = (x[c:-c, c:-c] for x in (a, a_cc, gt))
  return harness(a, gt), harness(a_cc, gt), rgb_cc

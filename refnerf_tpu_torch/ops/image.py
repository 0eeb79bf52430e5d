"""Image-space ops (counterpart of refnerf_tpu/ops/image.py:19-52).

Clamps are written `torch.maximum` against a tensor constant: at a tie that
splits the gradient 0.5/0.5, as JAX's `jnp.maximum` does, where
`torch.clamp` would pass all of it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def linear_to_srgb(linear, eps=_EPS):
  """sRGB OETF; assumes linear in [0, 1]."""
  srgb0 = 323 / 25 * linear
  srgb1 = (211 * torch.maximum(linear.new_tensor(eps), linear)**(5 / 12)
           - 11) / 200
  return torch.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb, eps=_EPS):
  """Inverse of linear_to_srgb."""
  linear0 = 25 / 323 * srgb
  linear1 = torch.maximum(srgb.new_tensor(eps),
                          (200 * srgb + 11) / 211)**(12 / 5)
  return torch.where(srgb <= 0.04045, linear0, linear1)


def mse_to_psnr(mse):
  """PSNR in dB of a mean squared error (signal range 1)."""
  return -10.0 / math.log(10.0) * torch.log(mse)


def clip01(x):
  """x clipped to [0, 1] with JAX's subgradient 0.5 at either bound."""
  return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def psnr_to_mse(psnr):
  """MSE from PSNR, assuming max pixel value 1."""
  return torch.exp(-0.1 * math.log(10.0) * psnr)


def ssim_to_dssim(ssim):
  return (1 - ssim) / 2


def dssim_to_ssim(dssim):
  return 1 - 2 * dssim


def downsample(img, factor):
  """Area-downsample img; factor must divide height and width."""
  sh = img.shape
  if not (sh[0] % factor == 0 and sh[1] % factor == 0):
    raise ValueError(f'Downsampling factor {factor} does not '
                     f'evenly divide image shape {tuple(sh[:2])}')
  img = img.reshape((sh[0] // factor, factor, sh[1] // factor, factor)
                    + tuple(sh[2:]))
  return img.mean((1, 3))


# lstsq's default cut-off on the normal equations' singular values,
# 10 eps (JAX image.py:105-118), as a cut-off on those of the system itself.
_CC_RTOL = math.sqrt(10 * float(np.finfo(np.float64).eps))


def color_correct(img, ref, num_iters=5, eps=0.5 / 255):
  """Warp `img`'s colors to match `ref` by iterated masked least squares
  (JAX image.py:65-130), in float64 on the device of `img`.

  Each channel's least squares over the unclipped pixels (the other rows
  zeroed, as in JAX) is solved from the QR factors of the system: its
  minimum-norm solution through the pseudo-inverse of R, dropping singular
  values below JAX's cut-off (lstsq's default on the normal equations,
  taken to the system's own singular values). The JAX package forms the
  normal equations instead, whose smallest singular values are rounding
  noise when the image's colours vary little (an untrained render): there
  the answer moves with the order of the pixels' sums, by dB of PSNR,
  between runs as between devices. Elsewhere the two agree to ~1e-12.
  Returns a float64 tensor of img's shape.
  """
  img = torch.as_tensor(img).to(torch.float64)
  ref = torch.as_tensor(ref).to(device=img.device, dtype=torch.float64)
  if img.shape[-1] != ref.shape[-1]:
    raise ValueError(
        f"img's {img.shape[-1]} and ref's {ref.shape[-1]} channels must match")
  num_channels = img.shape[-1]
  img_mat = img.reshape(-1, num_channels)
  ref_mat = ref.reshape(-1, num_channels)
  is_unclipped = lambda z: (z >= eps) & (z <= (1 - eps))
  mask0 = is_unclipped(img_mat)
  ref_unclipped = is_unclipped(ref_mat)
  for _ in range(num_iters):
    # Quadratic expansion of each pixel + linear + bias terms.
    a_mat = [img_mat[:, c:(c + 1)] * img_mat[:, c:]
             for c in range(num_channels)]
    a_mat = torch.cat(a_mat + [img_mat, torch.ones_like(img_mat[:, :1])],
                      dim=-1)
    # Ignore rows saturated in the input or in the current estimate.
    mask = (mask0 & is_unclipped(img_mat) & ref_unclipped).T  # [C, N]
    ma_mat = torch.where(mask[..., None], a_mat, a_mat.new_zeros(()))
    q, r = torch.linalg.qr(ma_mat)                            # R [C, 10, 10]
    qtb = q.transpose(1, 2) @ torch.where(
        mask, ref_mat.T, ref_mat.new_zeros(()))[..., None]    # [C, 10, 1]
    warp = (torch.linalg.pinv(r, rtol=_CC_RTOL) @ qtb)[..., 0].T  # [10, C]
    img_mat = clip01(a_mat @ warp)
  if not torch.isfinite(img_mat).all():
    raise FloatingPointError('color_correct produced non-finite values')
  return img_mat.reshape(img.shape)


def _gaussian_kernel1d(size, sigma):
  x = np.arange(size, dtype=np.float64) - (size - 1) / 2
  k = np.exp(-0.5 * (x / sigma) ** 2)
  return (k / k.sum()).astype(np.float32)


def _blur_valid(x, kernel, dim):
  """Valid-mode convolution of x with a symmetric 1D kernel along `dim`,
  as a weighted sum of shifted slices (f32 products and sums: no TF32)."""
  n = x.shape[dim] - len(kernel) + 1
  return sum(float(k) * x.narrow(dim, i, n) for i, k in enumerate(kernel))


def ssim(img0, img1, max_val=1.0, filter_size=11, filter_sigma=1.5,
         k1=0.01, k2=0.03, return_map=False):
  """Structural similarity (Wang et al. 2004), dm_pix-compatible defaults
  (JAX image.py:138-181): img0/img1 [H, W, C] in [0, max_val], a separable
  Gaussian window with VALID padding, along H then W."""
  img0 = torch.as_tensor(img0).float()
  img1 = torch.as_tensor(img1).to(device=img0.device, dtype=torch.float32)
  kernel = _gaussian_kernel1d(filter_size, filter_sigma)
  blur = lambda x: _blur_valid(_blur_valid(x, kernel, 0), kernel, 1)

  mu0 = blur(img0)
  mu1 = blur(img1)
  mu00 = mu0 * mu0
  mu11 = mu1 * mu1
  mu01 = mu0 * mu1
  sigma00 = blur(img0 * img0) - mu00
  sigma11 = blur(img1 * img1) - mu11
  sigma01 = blur(img0 * img1) - mu01

  # Clip variances/covariances to valid values (matches dm_pix/tf.image).
  zero = sigma00.new_zeros(())
  sigma00 = torch.maximum(zero, sigma00)
  sigma11 = torch.maximum(zero, sigma11)
  sigma01 = torch.sign(sigma01) * torch.minimum(
      torch.sqrt(sigma00 * sigma11), torch.abs(sigma01))

  c1 = (k1 * max_val) ** 2
  c2 = (k2 * max_val) ** 2
  numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
  denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
  ssim_map = numer / denom
  if return_map:
    return ssim_map
  return torch.mean(ssim_map)

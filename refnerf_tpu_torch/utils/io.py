"""Image and file IO (counterpart of refnerf_tpu/utils/io.py:11-41).

Images are read through Pillow, as the JAX package reads them, when it
imports. Without it, a small codec of the port's own, on numpy and zlib,
reads PNG, so that such a machine still loads the Blender and LLFF scenes:
non-interlaced 8- and 16-bit grey, grey with alpha, RGB and RGBA with all
five row filters, returned as `np.array(Image.open(f))` returns them (16-bit
grey as uint16, 16-bit colour as its high bytes, uint8). Its Average and
Paeth rows run byte by byte in Python, so it is the slow path. Other formats
(JPEG, TIFF) and PNGs the codec does not read need Pillow. PNG is written by
the codec, with filter 0, and TIFF through Pillow.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# PNG colour type -> channels (grey, RGB, grey + alpha, RGBA).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _pillow(pth):
  """Pillow's Image module, or an ImportError that names the file."""
  try:
    from PIL import Image
  except ImportError as e:
    raise ImportError(
        f'{pth}: only PNG is read and written without Pillow, which is not '
        'installed') from e
  return Image


def _unfilter(data, height, stride, bpp):
  """Undo the per-row filters of PNG's filter method 0: [height, stride]
  uint8. Sub and Up are vectorised; Average and Paeth, whose bytes depend
  on the byte bpp to the left, run over the row's bytes."""
  rows = np.frombuffer(data, np.uint8)
  if rows.size != height * (stride + 1):
    raise ValueError(f'PNG data holds {rows.size} bytes, expected '
                     f'{height * (stride + 1)}')
  rows = rows.reshape(height, stride + 1)
  out = np.empty((height, stride), np.uint8)
  prev = np.zeros(stride, np.uint8)
  for y in range(height):
    kind, line = rows[y, 0], rows[y, 1:]
    if kind == 0:
      cur = line.copy()
    elif kind == 1:   # Sub: a running sum of each byte lane, mod 256.
      cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                      dtype=np.uint8).reshape(-1)
    elif kind == 2:   # Up
      cur = line + prev
    elif kind in (3, 4):
      cur = bytearray(line.tobytes())
      up = prev.tobytes()
      for i in range(stride):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:  # Average
          cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
        else:          # Paeth
          c = up[i - bpp] if i >= bpp else 0
          p = a + b - c
          pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
          pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
          cur[i] = (cur[i] + pred) & 0xFF
      cur = np.frombuffer(bytes(cur), np.uint8)
    else:
      raise ValueError(f'PNG row {y} has filter type {kind}')
    out[y] = cur
    prev = out[y]
  return out


def decode_png(buf: bytes) -> np.ndarray:
  """Decode PNG bytes to uint8 or uint16 [H, W] (grey) or [H, W, C]."""
  if buf[:8] != _SIGNATURE:
    raise ValueError('not a PNG file')
  pos, header, idat = 8, None, []
  while pos < len(buf):
    (length,) = struct.unpack('>I', buf[pos:pos + 4])
    kind = buf[pos + 4:pos + 8]
    body = buf[pos + 8:pos + 8 + length]
    pos += 12 + length
    if kind == b'IHDR':
      header = struct.unpack('>IIBBBBB', body)
    elif kind == b'IDAT':
      idat.append(body)
    elif kind == b'IEND':
      break
  if header is None or not idat:
    raise ValueError('PNG without IHDR or IDAT')
  width, height, depth, color, _, _, interlace = header
  if color not in _CHANNELS or depth not in (8, 16) or interlace:
    raise ValueError(f'unsupported PNG: colour type {color}, bit depth '
                     f'{depth}, interlace {interlace} (Pillow reads it)')
  channels, nbytes = _CHANNELS[color], depth // 8
  bpp = channels * nbytes
  raw = _unfilter(zlib.decompress(b''.join(idat)), height, width * bpp, bpp)
  if nbytes == 2:
    raw = raw.view('>u2').astype(np.uint16)
    if channels > 1:
      raw = (raw >> 8).astype(np.uint8)
  img = raw.reshape(height, width, channels)
  return img[..., 0] if channels == 1 else img


def encode_png(img: np.ndarray) -> bytes:
  """Encode uint8 or uint16 [H, W] or [H, W, C] (C in 1-4) as PNG bytes,
  every row with filter 0."""
  img = np.asarray(img)
  if img.dtype not in (np.uint8, np.uint16):
    raise ValueError(f'PNG needs uint8 or uint16, got {img.dtype}')
  if img.ndim == 2:
    img = img[..., None]
  height, width, channels = img.shape
  if channels not in _COLOR_TYPE:
    raise ValueError(f'PNG cannot hold {channels} channels')
  depth = 8 * img.dtype.itemsize
  rows = img.astype(img.dtype.newbyteorder('>')).reshape(height, -1)
  rows = rows.view(np.uint8)
  raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

  def chunk(kind, body):
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack('>I', len(body)) + kind + body + struct.pack('>I', crc)

  header = struct.pack('>IIBBBBB', width, height, depth,
                       _COLOR_TYPE[channels], 0, 0, 0)
  return (_SIGNATURE + chunk(b'IHDR', header) +
          chunk(b'IDAT', zlib.compress(raw.tobytes())) +
          chunk(b'IEND', b''))


def read_image(pth: str) -> np.ndarray:
  """The image at `pth` as `np.array(Image.open(pth))` gives it: through
  Pillow, or a PNG by the port's codec where Pillow does not import."""
  with open(pth, 'rb') as f:
    buf = f.read()
  if buf[:8] == _SIGNATURE:
    try:
      import PIL.Image  # noqa: F401
    except ImportError:
      return decode_png(buf)
  return np.array(_pillow(pth).open(io.BytesIO(buf)))


def load_img(pth: str) -> np.ndarray:
  """Load an image as float32 (no scaling)."""
  return np.array(read_image(pth), dtype=np.float32)


def save_img_u8(img, pth, mask=None):
  """Save an image in [0, 1] as a uint8 PNG (optional acc-mask overlay)."""
  img_np = (np.clip(np.nan_to_num(np.asarray(img)), 0.0, 1.0)
            * 255).astype(np.uint8).squeeze()
  if mask is not None:
    mask_np = np.nan_to_num(np.asarray(mask)).astype(np.float32).squeeze()
    rng = mask_np.max() - mask_np.min()
    mask_np = 255 * (mask_np - mask_np.min()) / (rng if rng else 1.0)
    img_np = (255 - mask_np) + img_np
    rng2 = img_np.max() - img_np.min()
    img_np = np.array(255 * (img_np - img_np.min()) / (rng2 if rng2 else 1.0),
                      dtype=np.uint8)
  with open(pth, 'wb') as f:
    f.write(encode_png(img_np))


def save_img_f32(depthmap, pth):
  """Save a float map (e.g. depth) as a 32-bit TIFF (needs Pillow)."""
  image = _pillow(pth).fromarray(
      np.nan_to_num(np.asarray(depthmap)).astype(np.float32))
  with open(pth, 'wb') as f:
    image.save(f, 'TIFF')


def makedirs(pth):
  os.makedirs(pth, exist_ok=True)

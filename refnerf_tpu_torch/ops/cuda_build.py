"""Build and load the port's CUDA kernels (nvcc into a plain-C shared library).

The sources under `refnerf_tpu_torch/csrc/` expose `extern "C"` entry points
and include no PyTorch header, so one `nvcc` call builds them in seconds. The
library lands in `build/refnerf_tpu_torch/` at the root of the checkout, named
by a hash of the sources and flags, and is loaded with ctypes. Nothing here
runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'refnerf_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
# refnerf_trunk_fwd(dtype, width, hc, x0, d0, x1, d1, n, kin, depth, skip,
#                   w, b, wd, wh, bh, hf, wc, bc, sig, hout, cout, stream)
_TRUNK_FWD_ARGTYPES = [_I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P]


def _nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  default = pathlib.Path('/usr/local/cuda/bin/nvcc')
  if default.exists():
    return str(default)
  raise RuntimeError(
      'nvcc not found (looked on PATH and in /usr/local/cuda/bin): the CUDA '
      'kernels of refnerf_tpu_torch are built from source at first use.')


def _sources():
  return sorted(p for p in CSRC.iterdir() if p.suffix in ('.cu', '.cuh'))


def library_path() -> pathlib.Path:
  """Where the library for the current sources and flags lives."""
  h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for src in _sources():
    h.update(src.name.encode())
    h.update(src.read_bytes())
  return BUILD_DIR / f'librefnerf_kernels_{h.hexdigest()[:16]}.so'


def build() -> pathlib.Path:
  """Compile the kernels unless this exact build exists; returns the .so path.

  The compiler's output (register and shared-memory use per kernel, from
  `-Xptxas=-v`) is kept beside the library as `<name>.log`. Raises
  RuntimeError with nvcc's stderr when the build fails.
  """
  out = library_path()
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
  cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
         *[str(s) for s in _sources() if s.suffix == '.cu']]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(
        f'nvcc failed ({proc.returncode}): {" ".join(cmd)}\n{proc.stderr}')
  out.with_suffix('.log').write_text(
      f'# {" ".join(cmd)}\n# {time.perf_counter() - t0:.1f} s\n'
      f'{proc.stdout}{proc.stderr}')
  os.replace(tmp, out)
  return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
  """The loaded kernel library, built on first call."""
  lib = ctypes.CDLL(str(build()))
  lib.refnerf_trunk_fwd.argtypes = _TRUNK_FWD_ARGTYPES
  lib.refnerf_trunk_fwd.restype = ctypes.c_int
  lib.refnerf_trunk_supports.argtypes = [_I, _I]
  lib.refnerf_trunk_supports.restype = ctypes.c_int
  return lib

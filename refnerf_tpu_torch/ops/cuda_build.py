"""Build and load the port's CUDA kernels (nvcc into plain-C shared libraries).

Each source `refnerf_tpu_torch/csrc/<name>.cu` exposes `extern "C"` entry
points, includes no PyTorch header and becomes a library of its own, so one
`nvcc` per source builds in seconds and all of them run at once. The
libraries land in `build/refnerf_tpu_torch/` at the root of the checkout,
named by a hash of the sources and flags, and are loaded with ctypes. Nothing
here runs at import time: the first kernel launch builds.
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
from typing import Dict

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'refnerf_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# The entry points of each library and their ctypes signatures (every
# pointer and the stream as c_void_p, every int as c_int, every float as
# c_float).
EXPORTS = {
    'trunk_fwd': {
        # (dtype, width, hc, x0, d0, x1, d1, n, kin, depth, skip, w, wt, b,
        #  wd, wh, bh, hf, wc, bc, fold, nb, sig, hout, cout, u,
        #  g, v, k, ide_p, lmax, geo, mat, sg, gm, rawd, rawt, rgb,
        #  premult, rbias, pad, lm, lv, delta, bsig, samples, wts, y, stream)
        'refnerf_trunk_fwd': [_I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I,
                              _P, _P, _P, _P,
                              _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                              _F, _F, _F, _P, _P, _P, _P, _I, _P, _P, _P],
        'refnerf_trunk_supports': [_I, _I],
    },
    'trunk_bwd': {
        # (dtype, width, hc, x0, d0, x1, d1, n, kin, depth, skip, w, wt, b,
        #  wd, wh, bh, hf, wct, sbar, hbar, cbar, ubar, fold, nb, dx0, dx1,
        #  dxs, rp, hs, zs, ss, ps, xs, ts, cs, vec, nvec,
        #  g, v, k, ide_p, lmax, geo, mat, sg, gm, ddg, ddk,
        #  rawd, rawt, rgb_bar, drawd, drawt, premult, rbias, pad,
        #  lm, lv, delta, bsig, sig, wbar, samples, ybar, stream)
        'refnerf_trunk_bwd': [_I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                              _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                              _P, _P, _P, _P, _I,
                              _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _F, _F, _F,
                              _P, _P, _P, _P, _P, _P, _I, _P, _P],
        # (dtype, M, N, ncut, rp, ksplit, z, a, x, s, pa, tx, out, stream)
        'refnerf_wgrad': [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                          _P],
        # (parts, nparts, rows, k, k_out, dst, accumulate, stream)
        'refnerf_reduce': [_P, _I, _I, _I, _I, _P, _I, _P],
    },
}


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


def library_path(name: str) -> pathlib.Path:
  """Where the library of `csrc/<name>.cu` for the current sources and flags
  lives (the hash covers every source, headers included)."""
  h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for src in _sources():
    h.update(src.name.encode())
    h.update(src.read_bytes())
  return BUILD_DIR / f'librefnerf_{name}_{h.hexdigest()[:16]}.so'


def build() -> Dict[str, pathlib.Path]:
  """Compile every library that does not exist yet, one nvcc process per
  source, all started together; returns {name: .so path}.

  The compiler's output (register and shared-memory use per kernel, from
  `-Xptxas=-v`) is kept beside each library as `<name>.log`. Raises
  RuntimeError with nvcc's stderr when a build fails.
  """
  outs = {name: library_path(name) for name in EXPORTS}
  todo = {name: out for name, out in outs.items() if not out.exists()}
  if not todo:
    return outs
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = _nvcc()
  jobs = {}
  for name, out in todo.items():
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    jobs[name] = (cmd, tmp, proc, time.perf_counter())
  failed = []
  for name, (cmd, tmp, proc, t0) in jobs.items():
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
      tmp.unlink(missing_ok=True)
      failed.append(f'nvcc failed ({proc.returncode}): {" ".join(cmd)}\n'
                    f'{stderr}')
      continue
    out = todo[name]
    out.with_suffix('.log').write_text(
        f'# {" ".join(cmd)}\n# {time.perf_counter() - t0:.1f} s\n'
        f'{stdout}{stderr}')
    os.replace(tmp, out)
  if failed:
    raise RuntimeError('\n'.join(failed))
  return outs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
  """The loaded library of `csrc/<name>.cu`, built (with the others) on
  first call."""
  lib = ctypes.CDLL(str(build()[name]))
  for fn, argtypes in EXPORTS[name].items():
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
  return lib

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
# The per-tile backward's arguments:
# (dtype, width, hc, x0, d0, x1, d1, n, kin, depth, skip, w, wt, b,
#  wd, wh, bh, hf, wct, sbar, hbar, cbar, ubar, fold, nb, dx0, dx1,
#  dxs, rp, hs, zs, ss, ps, xs, ts, cs, vec, nvec,
#  g, v, k, ide_p, lmax, geo, mat, sg, gm, ddg, ddk,
#  rawd, rawt, rgb_bar, drawd, drawt, premult, rbias, pad,
#  lm, lv, delta, bsig, sig, wbar, samples, ybar, stream)
_BWD_ARGS = [_I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I,
             _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
             _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P,
             _P, _P, _P, _P, _I,
             _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
             _P, _P, _P, _P, _P, _F, _F, _F,
             _P, _P, _P, _P, _P, _P, _I, _P, _P]
# The weight-gradient product's: (dtype, M, N, ncut, rp, ksplit, z, a, x, s,
# pa, tx, out, stream).
_WGRAD_ARGS = [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P]
# The entry points of each library and their ctypes signatures (every
# pointer and the stream as c_void_p, every int as c_int, every float as
# c_float).
# The forward's arguments:
# (dtype, width, hc, x0, d0, x1, d1, n, kin, depth, skip, w, wt, b,
#  wd, wh, bh, hf, wc, bc, fold, nb, sig, hout, cout, u,
#  g, v, k, ide_p, lmax, geo, mat, sg, gm, rawd, rawt, rgb,
#  premult, rbias, pad, lm, lv, delta, bsig, samples, wts, y, stream)
_FWD_ARGS = [_I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _I,
             _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I,
             _P, _P, _P, _P,
             _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
             _F, _F, _F, _P, _P, _P, _P, _I, _P, _P, _P]
EXPORTS = {
    'trunk_fwd': {
        'refnerf_trunk_fwd': _FWD_ARGS,
        'refnerf_trunk_supports': [_I, _I],
    },
    # The bf16 width-256 forward (wgmma, TMA): the same arguments.
    'trunk_fwd_tma': {
        'refnerf_trunk_fwd_tma': _FWD_ARGS,
    },
    # The f32 width-256 forward (FMA products, TMA): the same arguments,
    # the head transposed.
    'trunk_fwd_f32': {
        'refnerf_trunk_fwd_f32': _FWD_ARGS,
    },
    'trunk_bwd': {
        'refnerf_trunk_bwd': _BWD_ARGS,
        'refnerf_wgrad': _WGRAD_ARGS,
        # (parts, nparts, rows, k, k_out, dst, accumulate, stream)
        'refnerf_reduce': [_P, _I, _I, _I, _I, _P, _I, _P],
    },
    # The bf16 width-256 backward (wgmma, TMA): the same arguments, the
    # weight-gradient operands sample-major.
    'trunk_bwd_tma': {
        'refnerf_trunk_bwd_tma': _BWD_ARGS,
        'refnerf_wgrad_tma': _WGRAD_ARGS,
    },
    # The f32 width-256 backward (FMA products, TMA): the same arguments,
    # the weight-gradient operands sample-major, the head untransposed.
    'trunk_bwd_f32': {
        'refnerf_trunk_bwd_f32': _BWD_ARGS,
        'refnerf_wgrad_f32': _WGRAD_ARGS,
    },
    # The width-1024 spatial trunk, layer by layer (both dtypes, both
    # directions): the products (bf16, mode, M, N, a0, lda0, k0, a1, lda1,
    # k1, b, b_lo, ldb, bias, act, ld_act, sb, wd, out, ldo, stream:
    # `NtParams`; f32 takes B as its TF32 parts b and b_lo, bf16 b_lo
    # null), the weights' TF32 split (n, v, hi, lo, stream), sigma (bf16, M,
    # W, y, wd, sig, stream), the weight gradients' partials (bf16, Mo, No,
    # rows, ksplit, z, ldz, x0, ldx0, n0, x1, ldx1, part, bpart, stream;
    # bpart, the bias gradient's partials, or null) and the column sums
    # (vbf16, rows, cols, v, ldv, s, block_rows, part, stream); trunk_bwd's
    # refnerf_reduce sums the partials.
    'trunk_w1024': {
        'refnerf_w1024_nt': [_I, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P,
                             _I, _P, _P, _I, _P, _P, _P, _I, _P],
        'refnerf_w1024_split': [_I, _P, _P, _P, _P],
        'refnerf_w1024_sigma': [_I, _I, _I, _P, _P, _P, _P],
        'refnerf_w1024_tn': [_I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _P, _I,
                             _P, _P, _P],
        'refnerf_w1024_colsum': [_I, _I, _I, _P, _I, _P, _I, _P, _P],
    },
    # The depth-1 directional trunk (both dtypes): the forward (bf16, M, d1,
    # hf, x0, x1, w, w_lo, b, wh, bh, rgb, stream), the backward (bf16, M,
    # d1, hf, x0, x1, w, w_lo, wt, wt_lo, b, wh, hbar, dx0, dx1, z, x1p,
    # hpart, nparts, stream; f32 takes W1 and W1^T as their TF32 parts, bf16
    # the lows null), the head partials a backward writes (bf16, M) and the
    # weights' TF32 split (rows, cols, v, hi, lo, perm8, stream);
    # trunk_w1024's refnerf_w1024_tn and trunk_bwd's refnerf_reduce form the
    # layer's weight gradient.
    'trunk_dir1': {
        'refnerf_dir1_fwd': [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P],
        'refnerf_dir1_bwd': [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _P, _I, _P],
        'refnerf_dir1_parts': [_I, _I],
        'refnerf_dir1_split': [_I, _I, _P, _P, _P, _I, _P],
    },
    # The f32 density-gradient forward (K3) of the wide-input spatial trunk
    # on three TF32 passes of wgmma: a panel tensor split into its TF32
    # parts (n, idx, w, nw, wc, hi, lo, stream) and the forward (n, d,
    # depth, skip, nb, x0, x1, bh, bl, np, fh, fl, b, wd, bc, sig, cout, u,
    # stream).
    'trunk_wide_tf32': {
        'refnerf_wide_tf32_split': [_I, _P, _P, _I, _P, _P, _P, _P],
        'refnerf_wide_tf32_k3': [_I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                                 _P, _P, _P, _P, _P, _P, _P, _P],
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


def variant(name: str, define: str) -> ctypes.CDLL:
  """csrc/<name>.cu built a second time with -D<define> into a library of
  its own beside the others (`librefnerf_<name>_<define>_<hash>.so`), its
  ctypes signatures set. No wrapper loads one: the phase stamps of
  tools/bwd_phases.py (REFNERF_PHASES) and the designs a redesign replaced,
  which chip_smoke.py times beside it, are built so."""
  out = library_path(name)
  out = out.with_name(out.name.replace(f'_{name}_', f'_{name}_{define}_'))
  if not out.exists():
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, f'-D{define}', '-o', str(tmp),
           str(CSRC / f'{name}.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
      raise RuntimeError(f'nvcc failed: {" ".join(cmd)}\n{proc.stderr}')
    os.replace(tmp, out)
  lib = ctypes.CDLL(str(out))
  for fn, argtypes in EXPORTS[name].items():
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
  return lib

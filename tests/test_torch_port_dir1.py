"""The depth-1 directional trunk's library (csrc/trunk_dir1.cu) on the CPU.

mip-NeRF 360's directional trunk (1 x 128 on [bottleneck 256 | positional
encoding of degree 4, 27], the f32 rgb head of 3) runs on its own library
in both dtypes and both directions (`fused_mlp.dir1`). The kernels run only
on a card (tests/test_torch_port_cuda.py, chip_smoke.py phase 24); here:

- the routing: the new library for the shapes `dir1` names, the older
  pair (trunk_fwd.cu, trunk_bwd.cu) for every other shape past the TMA
  kernels' 256 input columns;
- `kernel_smem` against the C constants of the source;
- a model of the kernels' walk: the row tiles (a partial last one), each
  tile's span of the 27-column segment (its byte offset and size, 16-byte
  aligned for every whole tile, plain loads for a partial one) and its
  spread into wgmma's A fragments (the index arithmetic of the source);
  the head's reduce-scatter over a warp's rows (each sum owned once), its
  per-CTA partials summed in a fixed order against the plain sum;
- the wrappers (`_dir1_forward`, `_dir1_backward`) against the plain
  versions with the C entry points replaced by `_Dir1Sim`, a model of
  their contract on CPU memory (each argument list checked against
  `cuda_build.EXPORTS`; the f32 products as three TF32 passes, W1^T's
  parts in the permuted order the backward's fragments need), beside
  `_W1024Sim`'s weight-gradient product and reduction: rows 1, 63, 65,
  127, 129 and 600;
- in f32 the three TF32 passes, each 32-deep slice summed in f32, at K =
  288 within KERNEL_BOUND, one pass (hi.hi) above it.

Tolerances as chip_smoke.py's: values 1e-4 (float32) and 5e-2 (bfloat16)
of their largest entry, every derivative within 5e-3 / 5e-2 relative L2
(KERNEL_BOUND, GRAD_BOUND); the head partials' fixed-order sum within
float32 rounding (1e-6 relative) of the plain sum.
"""

import contextlib
import math
import weakref

import numpy as np
import pytest
import torch

from refnerf_tpu_torch.ops import fused_mlp
from tests.test_torch_port_mipnerf360 import (GRAD_BOUND, KERNEL_BOUND,
                                              _W1024Sim, _c_constants, _flat,
                                              _split, _tf32,
                                              _truncated_product, _view)

torch.set_num_threads(1)

SMS = 132  # an H100's SMs
PERM8 = [0, 2, 4, 6, 1, 3, 5, 7]  # W1^T's hidden units of every 8 (f32 dx)


def _rows(cdt):
  """Rows a tile of the kernels takes: 64 in bf16, 128 in f32."""
  return 64 if cdt == 'bfloat16' else 128


def _walk(m, cdt, sms=SMS):
  """csrc/trunk_dir1.cu's walk: {CTA: [(tile, first row, rows), ...]}, the
  CTAs min(tiles, sms), CTA b taking tiles b, b + grid, ..."""
  r = _rows(cdt)
  tiles = -(-m // r)
  grid = min(tiles, sms)
  return {b: [(t, t * r, min(r, m - t * r)) for t in range(b, tiles, grid)]
          for b in range(grid)}


def _perm_cols(cols):
  return torch.tensor([c - c % 8 + PERM8[c % 8] for c in range(cols)])


class _Dir1Sim(_W1024Sim):
  """The C entry points of csrc/trunk_dir1.cu as their comments state them,
  with _W1024Sim's (trunk_w1024.cu's weight-gradient product, trunk_bwd.cu's
  reduction), on CPU memory and a card of `sms` SMs: each call's arguments
  checked against cuda_build.EXPORTS and recorded, then run in torch with
  the kernels' casts; every write lies inside a live tensor from
  torch.empty; the head partials per CTA of `_walk`."""

  def __init__(self, sms=SMS):
    super().__init__()
    self.sms = sms

  def __getattr__(self, fn):
    if not fn.startswith('refnerf_dir1_'):
      return super().__getattr__(fn)
    from refnerf_tpu_torch.ops import cuda_build
    types = cuda_build.EXPORTS[fused_mlp.DIR1_LIBRARY][fn]
    impl = getattr(self, '_dir1_' + fn.rsplit('_', 1)[1])

    def call(*args):
      assert len(args) == len(types), (fn, len(args), len(types))
      for a, t in zip(args, types):
        assert not isinstance(a, torch.Tensor), fn
        t.from_param(a)
      self.calls.append(fn)
      return impl(*args)
    return call

  def _layer(self, bf, m, d1, x0, x1, w, w_lo, b):
    """(x padded to 288 columns, h) as the kernels compute them."""
    dt = torch.bfloat16 if bf else torch.float32
    x = torch.cat([_view(x0, m, 256, 256, dt), _view(x1, m, d1, d1, dt),
                   torch.zeros(m, 32 - d1, dtype=dt)], 1).float()
    wv = _view(w, 128, 288, 288, dt).float()
    if bf:
      acc = x @ wv.t()
    else:
      lo = _view(w_lo, 128, 288, 288, dt)
      assert torch.equal(_tf32(wv), wv) and torch.equal(_tf32(lo), lo)
      xh, xl = _split(x)
      acc = (xh @ wv.t() if self.passes == 1 else
             xl @ wv.t() + xh @ lo.t() + xh @ wv.t())
    rnd = lambda v: v.to(dt).float()
    bias = _view(b, 1, 128, 128, dt).float()
    return x, torch.relu(rnd(rnd(acc) + bias))

  def _dir1_fwd(self, bf, m, d1, hf, x0, x1, w, w_lo, b, wh, bh, rgb, stream):
    del stream
    if (not 1 <= d1 <= fused_mlp.DIR1_D1 or not 1 <= hf <= 3 or
        any(p % 16 for p in (x0, x1, w)) or bool(w_lo) == bool(bf)):
      return 1  # cudaErrorInvalidValue
    _, h = self._layer(bf, m, d1, x0, x1, w, w_lo, b)
    out = h @ _view(wh, hf, 128, 128, torch.float32).t() + _view(
        bh, 1, hf, hf, torch.float32)
    assert self.inside(rgb, m * hf * 4)
    _view(rgb, m, hf, hf, torch.float32).copy_(out)
    return 0

  def _dir1_bwd(self, bf, m, d1, hf, x0, x1, w, w_lo, wt, wt_lo, b, wh, hbar,
                dx0, dx1, z, x1p, hpart, nparts, stream):
    del stream
    cdt = 'bfloat16' if bf else 'float32'
    walk = _walk(m, cdt, self.sms)
    if (not 1 <= d1 <= fused_mlp.DIR1_D1 or not 1 <= hf <= 3 or
        any(p % 16 for p in (x0, x1, w, hbar, z, x1p, dx0)) or
        bool(w_lo) == bool(bf) or bool(wt) == bool(bf) or
        nparts < len(walk)):
      return 1
    dt, es = (torch.bfloat16, 2) if bf else (torch.float32, 4)
    for p, size in ((dx0, m * 256 * es), (dx1, m * d1 * es),
                    (z, m * 128 * es), (x1p, m * 32 * es),
                    (hpart, len(walk) * fused_mlp.DIR1_PARTS * 4)):
      assert self.inside(p, size), 'a write overruns its buffer'
    x, h = self._layer(bf, m, d1, x0, x1, w, w_lo, b)
    whv = _view(wh, hf, 128, 128, torch.float32)
    hb = _view(hbar, m, hf, hf, torch.float32)
    zeta = torch.where(h > 0, (hb @ whv).to(dt).float(), torch.zeros_like(h))
    if bf:
      dx = zeta @ _view(w, 128, 288, 288, dt).float()
    else:
      # W1^T's parts come with the hidden units of every 8 permuted.
      inv = torch.argsort(_perm_cols(128))
      th = _view(wt, 288, 128, 128, dt)[:, inv]
      tl = _view(wt_lo, 288, 128, 128, dt)[:, inv]
      assert torch.equal(_tf32(th), th) and torch.equal(_tf32(tl), tl)
      wv = _view(w, 128, 288, 288, dt) + _view(w_lo, 128, 288, 288, dt)
      assert torch.allclose(th + tl, wv.t(), rtol=1e-6, atol=1e-7)
      zh, zl = _split(zeta)
      dx = (zh @ th.t() if self.passes == 1 else
            zl @ th.t() + zh @ tl.t() + zh @ th.t())
    _view(dx0, m, 256, 256, dt).copy_(dx[:, :256].to(dt))
    _view(dx1, m, d1, d1, dt).copy_(dx[:, 256:256 + d1].to(dt))
    _view(z, m, 128, 128, dt).copy_(zeta.to(dt))
    _view(x1p, m, 32, 32, dt).copy_(x[:, 256:].to(dt))
    parts = _view(hpart, len(walk), fused_mlp.DIR1_PARTS,
                  fused_mlp.DIR1_PARTS, torch.float32)
    for cta, tiles in walk.items():
      rows = torch.cat([torch.arange(r0, r0 + n) for _, r0, n in tiles])
      part = torch.zeros(fused_mlp.DIR1_PARTS)
      part[:hf * 128] = (hb[rows].t() @ h[rows]).reshape(-1)
      part[384:384 + hf] = hb[rows].sum(0)
      parts[cta].copy_(part)
    return 0

  def _dir1_parts(self, bf, m):
    return len(_walk(m, 'bfloat16' if bf else 'float32', self.sms))

  def _dir1_split(self, rows, cols, v, hi, lo, perm8, stream):
    del stream
    vv = _view(v, rows, cols, cols, torch.float32)
    if perm8:
      vv = vv[:, _perm_cols(cols)]
    h, l = _split(vv)
    _view(hi, rows, cols, cols, torch.float32).copy_(h)
    _view(lo, rows, cols, cols, torch.float32).copy_(l)
    return 0


@pytest.fixture
def dir1_sim(monkeypatch):
  """cuda_build.library answers with a _Dir1Sim (the directional trunk's
  library, trunk_w1024's product and trunk_bwd's reduction), on a card of
  an H100's 132 SMs; the stream and device calls of the wrappers are
  no-ops; what torch.empty returns is registered with the sim."""
  from refnerf_tpu_torch.ops import cuda_build
  sim = _Dir1Sim()
  empty = torch.empty

  def library(name):
    assert name in (fused_mlp.DIR1_LIBRARY, fused_mlp.W1024_LIBRARY,
                    'trunk_bwd'), name
    return sim

  def registered(*args, **kwargs):
    t = empty(*args, **kwargs)
    sim.allocated.append(weakref.ref(t))
    return t
  monkeypatch.setattr(cuda_build, 'library', library)
  monkeypatch.setattr(torch, 'empty', registered)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda dev: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda dev=None: type('S', (), {'cuda_stream': 0})())
  monkeypatch.setattr(torch.cuda, 'get_device_properties',
                      lambda dev: type('P', (), {'multi_processor_count': SMS}))
  return sim


def _trunk(seed, n, d1=27, hf=3):
  """The directional trunk of MIPNERF360 at its widths: segments [n, 256]
  in [-1, 1] and the positional encoding of random unit directions (degree
  4, 27 columns; uniform where d1 differs), He-scaled W1, the rgb head, and
  rgb's cotangent."""
  from refnerf_tpu_torch.ops import coord
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.randn(*s, generator=gen)
  d = rand(n, 3)
  x1 = (coord.pos_enc(d / d.norm(dim=-1, keepdim=True), 0, 4) if d1 == 27
        else torch.rand(n, d1, generator=gen) * 2 - 1)
  segs = [torch.rand(n, 256, generator=gen) * 2 - 1, x1]
  ws, bs = [rand(128, 256 + d1) * math.sqrt(2 / (256 + d1))], [rand(128) * 0.05]
  kw = dict(skip_period=4, wd=None, head_f32=(rand(hf, 128) / 11.3,
                                              rand(hf) * 0.1), head_cdt=None)
  return segs, ws, bs, kw, (None, rand(n, hf), None, None)


def _pack(cdt, seg_dims=(256, 27), hf=3, depth=1, width=128):
  skips = fused_mlp.skip_input_layers(depth, 4)
  fin = sum(seg_dims)
  ws = [torch.zeros(width, fin if l == 0 else width + (fin if l in skips
                                                        else 0))
        for l in range(depth)]
  bs = [torch.zeros(width) for _ in range(depth)]
  head = (torch.zeros(hf, width), torch.zeros(hf)) if hf else None
  return fused_mlp.pack_trunk(ws, bs, seg_dims, head_f32=head,
                              compute_dtype=cdt)


# --------------------------------------------------------------- routing


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_dir1_routes_the_directional_trunk_of_mipnerf360(cdt):
  # 1 x 128 on (256, 27) with the rgb head: both directions on trunk_dir1
  # (counted as K2 / K5 alone), within an H100's shared memory; the
  # positional encoding of lower degrees (d1 3-21) and a 1- or 2-wide f32
  # head too.
  modes = (False, None, fused_mlp.DirModes(), fused_mlp.SpaModes())
  for dims, hf in (((256, 27), 3), ((256, 3), 3), ((256, 21), 1),
                   ((256, 29), 2)):
    pack = _pack(cdt, dims, hf)
    assert fused_mlp.dir1(pack) and pack.kin == 288, dims
    assert fused_mlp.forward_library(pack) == fused_mlp.DIR1_LIBRARY
    assert fused_mlp.backward_library(pack) == fused_mlp.DIR1_LIBRARY
    assert fused_mlp.missing_instance(pack, 0) is None
    assert fused_mlp.launch_keys('K2', pack, *modes) == ['K2']
    assert fused_mlp.launch_keys('K5', pack, *modes) == ['K5']
  assert fused_mlp.kernel_smem(fused_mlp.DIR1_LIBRARY, _pack(cdt), 0) <= (
      fused_mlp.SMEM_LIMIT)


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case,fwd,bwd', [
    # Past the TMA kernels' 256 input columns, not dir1's: the older pair.
    ('depth 8 on (128, 160)', 'trunk_fwd', 'trunk_bwd'),
    ('depth 2 on (256, 27)', 'trunk_fwd', 'trunk_bwd'),
    ('a 4-wide head', 'trunk_fwd', 'trunk_bwd'),
    ('(256, 30)', 'trunk_fwd', 'trunk_bwd'),
    ('(255, 28)', 'trunk_fwd', 'trunk_bwd'),
    ('(27, 256)', 'trunk_fwd', 'trunk_bwd'),
    ('three segments', 'trunk_fwd', 'trunk_bwd'),
])
def test_dir1_leaves_every_other_wide_shape_on_the_older_pair(cdt, case, fwd,
                                                             bwd):
  shape = {'depth 8 on (128, 160)': dict(seg_dims=(128, 160), depth=8),
           'depth 2 on (256, 27)': dict(depth=2),
           'a 4-wide head': dict(hf=4),
           '(256, 30)': dict(seg_dims=(256, 30)),
           '(255, 28)': dict(seg_dims=(255, 28)),
           '(27, 256)': dict(seg_dims=(27, 256)),
           'three segments': dict(seg_dims=(256, 13, 14))}[case]
  pack = _pack(cdt, **shape)
  assert pack.kin > fused_mlp._TMA_KIN and not fused_mlp.dir1(pack)
  assert fused_mlp.forward_library(pack) == fwd
  assert fused_mlp.backward_library(pack) == bwd


def test_dir1_smem_mirrors_the_c_constants():
  # kernel_smem's sum for trunk_dir1 is the source's `kBSmem` (bf16: W1
  # resident, 3 stages of a 64-row tile) and `kFSmem` (f32: 4 stages of
  # three [128][32] f32 slots), with the head and its 8 warps' sums, each
  # within an H100's SMEM_LIMIT.
  from refnerf_tpu_torch.ops import cuda_build
  c = _c_constants(cuda_build.CSRC / 'trunk_dir1.cu')
  assert (c['kBSmem'], c['kFSmem']) == (211112, 212144)
  for cdt, name in (('bfloat16', 'kBSmem'), ('float32', 'kFSmem')):
    assert fused_mlp.kernel_smem(fused_mlp.DIR1_LIBRARY, _pack(cdt), 0) == (
        c[name])
    assert c[name] <= fused_mlp.SMEM_LIMIT
  # The tile rows, the head partial's floats and the widest second segment
  # as the wrappers know them.
  assert (c['kBRows'], c['kFRows']) == (_rows('bfloat16'), _rows('float32'))
  assert c['kParts'] == fused_mlp.DIR1_PARTS
  assert c['kD1Max'] == fused_mlp.DIR1_D1 and c['kHf'] == fused_mlp.DIR1_HEADS
  # f32: a tile's span and its head cotangents share one 16 KB slot.
  assert _rows('float32') * 4 * (c['kD1Max'] + c['kHf']) <= c['kFSlot']
  assert _rows('float32') * 4 * (c['kD1Max'] + 1 + c['kHf']) > c['kFSlot']


# -------------------------------------------------- a model of the walk


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [1, 63, 65, 127, 129, 600, 524288])
def test_dir1_walk_covers_every_row_once(cdt, n):
  # The CTAs (one an SM, at most one a tile) walk the tiles in a fixed
  # order; every row lies in exactly one tile; only the last tile may be
  # partial. Each whole tile's 27-column span is one bulk copy: its byte
  # offset and size multiples of 16 (a 16-byte aligned base); a partial
  # one is read by plain loads.
  walk = _walk(n, cdt)
  assert len(walk) == min(-(-n // _rows(cdt)), SMS)
  seen = np.zeros(n, np.int64)
  es = 2 if cdt == 'bfloat16' else 4
  for tiles in walk.values():
    for t, r0, rows in tiles:
      seen[r0:r0 + rows] += 1
      whole = rows == _rows(cdt)
      assert whole or r0 + rows == n
      offset, size = r0 * 27 * es, rows * 27 * es
      if whole:
        assert offset % 16 == 0 and size % 16 == 0, (t, offset, size)
  assert (seen == 1).all()


def _bf16_fragments(span, rows, d1):
  """What the bf16 kernel's registers read of a tile's span (K 256-287): for
  each warp w of a consumer warpgroup and lane (g = lane / 4, q = lane % 4),
  xa[kk][i] holds rows 16 w + g + 8 (i % 2), columns 16 kk + 2 q + 8 (i /
  2) and the next (`pair`), zeros past d1 and past the rows. Returns the
  [64][32] A tile they make."""
  a = torch.full((64, 32), float('nan'))
  for w in range(4):
    for lane in range(32):
      g, q = lane // 4, lane % 4
      for kk in range(2):
        for i in range(4):
          r, c = 16 * w + g + 8 * (i % 2), 16 * kk + 2 * q + 8 * (i // 2)
          for e in range(2):
            ok = r < rows and c + e < d1
            a[r, c + e] = span[r * d1 + c + e] if ok else 0.0
  return a


def _f32_fragments(span, rows, d1):
  """The f32 kernel's (the last K slice): consumer warpgroup cw, warp w,
  lane (g, q), k8 step kk, register e: row 64 cw + 16 w + g + 8 (e % 2),
  column 8 kk + q + 4 (e / 2). Returns the [128][32] A tile."""
  a = torch.full((128, 32), float('nan'))
  for cw in range(2):
    for w in range(4):
      for lane in range(32):
        g, q = lane // 4, lane % 4
        for kk in range(4):
          for e in range(4):
            r = 64 * cw + 16 * w + g + 8 * (e % 2)
            c = 8 * kk + q + 4 * (e // 2)
            a[r, c] = span[r * d1 + c] if r < rows and c < d1 else 0.0
  return a


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [1, 63, 65, 127, 129])
def test_dir1_span_spreads_into_the_a_fragments(cdt, n):
  # Each tile's span, read as the kernels index it, makes the K 256-287
  # slice of the tile's A operand: the segment's rows with zeros past its
  # 27 columns and past the last row, every element read once.
  gen = torch.Generator().manual_seed(n)
  x1 = torch.rand(n, 27, generator=gen) + 1.0
  spread = _bf16_fragments if cdt == 'bfloat16' else _f32_fragments
  r = _rows(cdt)
  for tiles in _walk(n, cdt).values():
    for _, r0, rows in tiles:
      span = torch.cat([x1[r0:r0 + rows].reshape(-1),
                        torch.full((64,), float("nan"))])
      got = spread(span, rows, 27)
      want = torch.zeros(r, 32)
      want[:rows, :27] = x1[r0:r0 + rows]
      assert torch.equal(got, want), (cdt, n, r0)


def test_dir1_head_reduce_scatter_owns_each_sum_once():
  # The backward's head sums, a head output k at a time: lane (g, q) of a
  # warp keeps entries [4 g, 4 g + 4) of its 32 (dwh[k][8 j + 2 q + e] at 2
  # j + e) after the three halving steps (xor 16, 8, 4); over the warp's 32
  # lanes every column of dwh[k] is kept by exactly one lane, whose value
  # is the sum over the 8 lanes of its q, as the steps compute it.
  owner = {}
  for lane in range(32):
    g, q = lane // 4, lane % 4
    for i in range(4):
      c = 8 * (2 * g + (i >> 1)) + 2 * q + (i & 1)
      idx = 2 * (c // 8) + c % 2  # the lane's entry of column c
      assert c not in owner and idx == 4 * g + i
      owner[c] = (lane, i)
  assert sorted(owner) == list(range(128))
  # The halving steps on random values: lane l keeps the sums over l's 8
  # lanes of q of entries [4 g, 4 g + 4).
  gen = torch.Generator().manual_seed(0)
  v = torch.randn(32, 32, generator=gen, dtype=torch.float64)
  cur = v.clone()
  for step, half in ((16, 16), (8, 8), (4, 4)):
    nxt = cur.clone()
    for lane in range(32):
      # The partner keeps the other half, so it sends the half kept here.
      up = (lane // 4) & (step // 4)
      part = slice(half, 2 * half) if up else slice(0, half)
      nxt[lane, :half] = cur[lane, part] + cur[lane ^ step, part]
    cur = nxt
  for lane in range(32):
    g, q = lane // 4, lane % 4
    lanes = [4 * gg + q for gg in range(8)]
    want = v[lanes].sum(0)[4 * g:4 * g + 4]
    np.testing.assert_allclose(cur[lane, :4].numpy(), want.numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [600, 40000])
def test_dir1_head_partials_sum_in_a_fixed_order(cdt, n):
  # Each CTA sums its tiles' rows of dwh = hbar^T h and dbh; the wrapper
  # sums the CTAs' partials in order (refnerf_reduce): within float32
  # rounding of the plain sums, and the same bits every time.
  gen = torch.Generator().manual_seed(1)
  h = torch.relu(torch.randn(n, 128, generator=gen))
  hb = torch.randn(n, 3, generator=gen)
  walk = _walk(n, cdt)
  parts = []
  for tiles in walk.values():
    rows = torch.cat([torch.arange(r0, r0 + k) for _, r0, k in tiles])
    parts.append(torch.cat([(hb[rows].t() @ h[rows]).reshape(-1),
                            hb[rows].sum(0)]))
  total = torch.zeros(fused_mlp.DIR1_PARTS)
  for p in parts:
    total += p
  want = torch.cat([(hb.double().t() @ h.double()).reshape(-1),
                    hb.double().sum(0)])
  np.testing.assert_allclose(total.double().numpy(), want.numpy(),
                             rtol=1e-5, atol=1e-6 * want.abs().max().item())
  again = torch.zeros(fused_mlp.DIR1_PARTS)
  for p in parts:
    again += p
  assert torch.equal(total, again)


@pytest.mark.parametrize('sms', [132, 114])
def test_dir1_split_fits_its_scratch_for_every_row_count(sms):
  # H24: for every row count the weight gradient's split takes whole
  # 64-row (bf16) or 32-row (f32) slices in at most dir1_splits partials,
  # the count its scratch is sized by; the head partials (a CTA each) at
  # most the SMs, the count of theirs.
  rows = np.arange(1, 600001, 37)
  for cdt, q in (('bfloat16', 64), ('float32', 32)):
    most = fused_mlp.dir1_splits(sms, cdt)
    for r in rows:
      k = fused_mlp.dir1_split(int(r), sms, cdt)
      assert k % q == 0 and -(-r // k) <= most, (cdt, r, k, most)
      assert len(_walk(int(r), cdt, sms)) <= sms


# ------------------------------------- the wrappers on a model of the C


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [1, 63, 65, 127, 129, 600])
def test_dir1_wrappers_match_plain(dir1_sim, cdt, n):
  # The forward's rgb within KERNEL_BOUND of its largest value; the
  # backward's gradients (dW1, db1, dwh, dbh) and both segments'
  # cotangents within GRAD_BOUND relative L2 of trunk_reference and
  # trunk_backward_reference (needs_dx), in the segments' dtype; the
  # launches as the wrappers make them.
  segs, ws, bs, kw, cots = _trunk(3, n)
  dt = fused_mlp.DTYPES[cdt]
  segs = [s.to(dt) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (256, 27), compute_dtype=cdt, **kw)
  got = fused_mlp.trunk_kernel(segs, pack)
  want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt, **kw)
  assert len(got) == len(want) == 1 and got[0].shape == (n, 3)
  scale = max(1.0, want[0].abs().max().item())
  assert (got[0] - want[0]).abs().max().item() <= KERNEL_BOUND[cdt] * scale
  f32 = cdt == 'float32'
  assert dir1_sim.calls == ['refnerf_dir1_split'] * f32 + ['refnerf_dir1_fwd']
  dir1_sim.calls.clear()
  got = fused_mlp.trunk_backward_kernel(segs, pack, cots, needs_dx=True)
  want = fused_mlp.trunk_backward_reference(segs, ws, bs, cots,
                                            compute_dtype=cdt, needs_dx=True,
                                            **kw)
  assert got[2] is None and got[5:7] == (None, None) and got[8:] == (None,
                                                                      None)
  assert [d.dtype for d in got[7]] == [dt, dt]
  got, want = _flat(got), _flat(want)
  assert len(got) == len(want) == 6
  for i, (g, w) in enumerate(zip(got, want)):
    assert g.shape == w.shape and g.dtype == w.dtype, i
    err = ((g.float() - w.float()).norm() / w.float().norm()).item()
    assert err <= GRAD_BOUND[cdt], (i, err)
  assert dir1_sim.calls == (['refnerf_dir1_split'] * (2 * f32) +
                            ['refnerf_dir1_parts', 'refnerf_dir1_bwd',
                             'refnerf_w1024_tn'] + ['refnerf_reduce'] * 3)


def test_dir1_backward_without_dx_and_without_a_cotangent(dir1_sim):
  # Without needs_dx the segments' cotangents are None; rgb's cotangent
  # None is zero: every gradient 0.
  segs, ws, bs, kw, _ = _trunk(4, 70)
  pack = fused_mlp.pack_trunk(ws, bs, (256, 27), **kw)
  got = fused_mlp.trunk_backward_kernel(segs, pack, (None,) * 4)
  assert got[7] is None
  for g in _flat(got):
    assert not g.any()


@pytest.mark.parametrize('what', ['second', 'bottleneck'])
def test_dir1_refuses_a_misaligned_segment(dir1_sim, what):
  # The kernel reads the segments in place (TMA, bulk copies): a segment in
  # the compute dtype, contiguous but 2 bytes past a 16-byte boundary,
  # raises; it is not copied to hide it.
  segs, ws, bs, kw, cots = _trunk(5, 9)
  pack = fused_mlp.pack_trunk(ws, bs, (256, 27), compute_dtype='bfloat16',
                              **kw)
  segs = [s.to(torch.bfloat16) for s in segs]
  j = 1 if what == 'second' else 0
  buf = torch.zeros(segs[j].numel() + 8, dtype=torch.bfloat16)
  segs[j] = buf[1:1 + segs[j].numel()].view(segs[j].shape).copy_(segs[j])
  assert segs[j].is_contiguous() and segs[j].data_ptr() % 16
  with pytest.raises(ValueError, match=f'{what} segment'):
    fused_mlp.trunk_kernel(segs, pack)
  with pytest.raises(ValueError, match=f'{what} segment'):
    fused_mlp.trunk_backward_kernel(segs, pack, cots, needs_dx=True)
  assert dir1_sim.calls == []


@pytest.mark.parametrize('passes', [3, 1])
def test_dir1_tf32_passes_at_k288_against_the_f32_bound(dir1_sim, passes):
  # f32 at K = 288: three TF32 passes, each 32-deep slice summed into the
  # tile in f32 (`_truncated_product`, the tensor cores' truncating
  # accumulation modelled), within KERNEL_BOUND['float32'] of the exact
  # product; the whole forward through the wrapper within a tenth of it.
  # One pass (hi.hi alone) reads above the bound: the bound sees that
  # shortcut.
  segs, ws, bs, kw, _ = _trunk(6, 600)
  x = torch.cat([segs[0], segs[1], torch.zeros(600, 5)], 1)
  w = torch.cat([ws[0], torch.zeros(128, 5)], 1).t().contiguous()
  exact = x.double().numpy() @ w.double().numpy()
  scale = np.abs(exact).max()
  if passes == 3:
    sliced = _truncated_product(x, w, 32)
    assert np.abs(sliced - exact).max() <= KERNEL_BOUND['float32'] / 10 * scale
  dir1_sim.passes = passes
  pack = fused_mlp.pack_trunk(ws, bs, (256, 27), **kw)
  out = fused_mlp.trunk_kernel(segs, pack)[0]
  want = fused_mlp.trunk_reference(segs, ws, bs, **kw)[0]
  err = ((out - want).abs().max() / max(1.0, want.abs().max().item())).item()
  if passes == 3:
    assert err <= KERNEL_BOUND['float32'] / 10, err
  else:
    assert err > KERNEL_BOUND['float32'], err

"""mip-NeRF 360's f32 proposal trunk on the TF32 wide libraries, on the CPU.

The PropMLP's spatial trunk (4 x 256 on the IPE of 21 basis vectors x 12
degrees, two segments of 252 columns, the density head alone, no skip
layer; and 8 x 256 with the skip at layer 5) in f32 runs its forward (K1)
on csrc/trunk_wide_tf32.cu's head-0 instance (`refnerf_wide_tf32_k1h0`)
and its first-order backward (K4) on csrc/trunk_wide_bwd_tf32.cu's
(`refnerf_wide_tf32_k4h0`), three TF32 passes of wgmma fed by TMA. The
kernels run only on a card (tests/test_torch_port_cuda.py, chip_smoke.py
phase 19); here:

- the routes (`fused_mlp.wide_tf32`, `wide_tf32_bwd`, `forward_library`,
  `backward_library`) and each launch's shared memory (`kernel_smem`) at
  depths 4 and 8, and the shapes that keep their routes: the density
  gradient at the density head alone (K3, and K4 with u's cotangent), the
  128-wide head, an f32 head, bf16;
- the kernels' weight panels (`fused_mlp.tf32_panel_index` and
  `tf32_bwd_panel_index` without the head) run in the kernels' order in
  exact f32: sigma and every first-order gradient within 1e-6 of the
  largest entry of trunk_reference's and trunk_backward_reference's (the
  same products summed in another order; sigma at depth 8 within 2e-6);
- the kernels' arithmetic (each product three TF32 passes, every 32-deep
  slice summed into a fresh set added in f32: tests/test_torch_port_
  mipnerf360.py `_truncated_product`) against JAX reference_encoded_trunk
  with the density head alone at 64 rows: sigma within chip_smoke.py's
  KERNEL_BOUND['float32'] of max(1, its largest entry), every gradient
  within GRAD_BOUND['float32'] by relative L2; one pass (hi.hi alone)
  reads above a bound, and so do two planted faults of the backward's
  design (zeta_{L-1} without relu', and the x scratch holding each segment
  padded to 256 columns);
- the launch arguments against cuda_build.EXPORTS (`_ArgCheck`).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu.ops.pallas import fused_mlp as jfused
from refnerf_tpu_torch.ops import fused_mlp
from tests.test_torch_port_cascade import _ArgCheck
from tests.test_torch_port_mipnerf360 import (KERNEL_BOUND, _tf32_product,
                                              _truncated_product)

torch.set_num_threads(1)

GRAD_BOUND = {'float32': 5e-3}  # chip_smoke.py's
SCALES = tuple(float(2**d) for d in range(12))  # max_deg_point 12
NB = 21  # the icosahedron basis at 2 subdivisions
WIDTH = 256
SKIP = {4: -1, 8: 5}  # the pack's skip layer at each depth


def _t(a):
  return torch.tensor(np.ascontiguousarray(a))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32))


def _case(seed, depth, n=64):
  """The proposal trunk at full width on n rows: JAX's (weights [in, out],
  biases, wd [256, 1], lm, lv [n, 21]), the cotangent of sigma [n], the
  port's segments and pack (the density head alone)."""
  rng = np.random.default_rng(seed)
  fin = 2 * NB * len(SCALES)
  skips = fused_mlp.skip_input_layers(depth, 4)
  ks = [(rng.normal(size=(fin if l == 0 else WIDTH + (fin if l in skips
                                                      else 0), WIDTH)) *
         np.sqrt(2.0 / (fin if l == 0 else WIDTH))).astype(np.float32)
        for l in range(depth)]
  bs = [(rng.normal(size=WIDTH) * 0.05).astype(np.float32)
        for _ in range(depth)]
  wd = (rng.normal(size=(WIDTH, 1)) / 16).astype(np.float32)
  lm = rng.uniform(-1.5, 1.5, (n, NB)).astype(np.float32)
  lv = (10.0**rng.uniform(-6, -2, (n, NB))).astype(np.float32)
  sbar = _t(rng.normal(size=n).astype(np.float32))
  segs = list(fused_mlp.encode_ipe(_t(lm), _t(lv), SCALES))
  pack = fused_mlp.pack_trunk([_t(k.T) for k in ks], [_t(b) for b in bs],
                              (252, 252), wd=_t(wd.T))
  return (ks, bs, wd, lm, lv), sbar, segs, pack


def _perm(k):
  s = np.arange(k)
  return torch.from_numpy((s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4)


def _runner(panels, product):
  """A product A B^T over the next panels of `panels` (one a member of
  a_list), A's columns permuted within every 8 as the panels' K is."""
  perm = _perm(WIDTH)

  def run(a_list):
    a = torch.cat([t[:, perm] for t in a_list], 1).contiguous()
    b = torch.cat([next(panels).t() for _ in a_list], 0).contiguous()
    return product(a, b)
  return run


def _k1h0_model(pack, segs, product):
  """sigma as csrc/trunk_wide_tf32.cu's head-0 instance computes it: the
  layers over their panels (`fused_mlp.tf32_panels(pack, dg=False)`, no
  bottleneck's), h_l = relu(acc + b_l), sigma = y wd."""
  d = int(segs[0].shape[1])
  panels = iter(fused_mlp.tf32_panels(pack, dg=False).reshape(-1, WIDTH,
                                                               WIDTH))
  run = _runner(panels, product)
  x0, x1 = (torch.nn.functional.pad(x.float(), (0, WIDTH - d)) for x in segs)
  act = None
  for l in range(pack.depth):
    act = torch.relu(run([x0, x1] if l == 0 else [act, x0, x1]
                         if l == pack.skip else [act]) + pack.b[l])
  assert next(panels, None) is None  # every panel read, none left
  return act @ pack.wd


def _k4h0_model(pack, segs, sbar, product, faults=()):
  """The first-order backward as csrc/trunk_wide_bwd_tf32.cu's head-0
  instance and its wrapper (`fused_mlp._wide_tf32_backward`) compute it:
  the recompute over its panels (`fused_mlp.tf32_bwd_panels(pack, False)`,
  no head's), zeta_{L-1} = relu'(h_{L-1}) (sbar wd) with no product, the
  reverse zeta_{l-1} = relu'(h_{l-1}) (zeta_l W_l^T); the weight gradients
  as trunk_w1024.cu's tn product forms them, product(z^T, x) over the rows,
  x the scratch's [n, 512] (the segments side by side, zeros past 504);
  db_l and dwd = sum sbar y in f32. Planted `faults`: 'head unmasked'
  (zeta_{L-1} without relu'), 'x padded' (the x scratch holding each
  segment padded to 256 columns). Returns (y, dws, dbs, dwd)."""
  d, L = int(segs[0].shape[1]), pack.depth
  panels = iter(fused_mlp.tf32_bwd_panels(pack, False).reshape(-1, WIDTH,
                                                                WIDTH))
  run = _runner(panels, product)
  pad = lambda x, k: torch.nn.functional.pad(x.float(), (0, k - x.shape[1]))
  x0, x1 = (pad(x, WIDTH) for x in segs)
  xcat = (torch.cat([x0, x1], 1) if 'x padded' in faults
          else pad(torch.cat([segs[0], segs[1]], 1), 2 * WIDTH))
  hs, masks, act = [], [], None
  for l in range(L):
    act = torch.relu(run([x0, x1] if l == 0 else [act, x0, x1]
                         if l == pack.skip else [act]) + pack.b[l])
    hs.append(act)
    masks.append(act > 0)
  zs = [None] * L
  zs[-1] = sbar[:, None] * pack.wd
  if 'head unmasked' not in faults:
    zs[-1] = masks[-1] * zs[-1]
  for l in range(L - 1, 0, -1):
    zs[l - 1] = masks[l - 1] * run([zs[l]])
  assert next(panels, None) is None
  wg = lambda z, x: product(z.t().contiguous(), x.contiguous())
  fin, kin = 2 * d, pack.kin
  dws = []
  for l in range(L):
    xl = (xcat[:, :kin] if l == 0 else
          torch.cat([hs[l - 1], xcat[:, :kin]], 1) if l == pack.skip
          else hs[l - 1])
    dws.append(wg(zs[l], xl)[:, :(fin if l == 0 else WIDTH + (
        fin if l == pack.skip else 0))])
  dbs = [z.sum(0) for z in zs]
  dwd = (sbar[:, None] * hs[-1]).sum(0)[None]
  return hs[-1], dws, dbs, dwd


def _product(passes):
  if passes == 3:
    return lambda a, b: torch.from_numpy(_truncated_product(a, b, 32)).float()
  return lambda a, b: _tf32_product(a, b, passes=1)


def _jax(case, sbar):
  """JAX reference_encoded_trunk with the density head alone: sigma [n],
  and the gradients of <sbar, sigma> (weights [in, out], biases, wd)."""
  ks, bs, wd, lm, lv = case

  def ref(ks_, bs_, wd_):
    return jfused.reference_encoded_trunk(
        jnp.asarray(lm), jnp.asarray(lv), SCALES, ks_, bs_, wd_,
        skip_period=4)
  jsig, vjp = jax.vjp(ref, [jnp.asarray(k) for k in ks],
                      [jnp.asarray(b) for b in bs], jnp.asarray(wd))
  grads = vjp(jnp.asarray(sbar.numpy()).reshape(jsig.shape))
  return _np(jsig).reshape(-1), grads


def _sigma_read(sig, jsig):
  return float((sig - _t(jsig)).abs().max()) / max(
      1.0, float(np.abs(jsig).max())) / KERNEL_BOUND['float32']


def _grad_reads(got, jgrads):
  """Each gradient's relative L2 distance from JAX's as a share of
  GRAD_BOUND (the port's layout: weights [out, in], wd [1, out])."""
  dws, dbs, dwd = got
  jks, jbs, jwd = jgrads
  l2 = lambda a, b: float((a.float() - b).norm() / b.norm()) / GRAD_BOUND[
      'float32']
  return ([l2(dws[l], _t(_np(jks[l]).T)) for l in range(len(dws))] +
          [l2(dbs[l], _t(_np(jbs[l]))) for l in range(len(dbs))] +
          [l2(dwd, _t(_np(jwd).T))])


# --------------------------------------------------------------- the routes


@pytest.mark.parametrize('depth', [4, 8])
def test_prop_f32_routes_to_the_tf32_libraries(depth):
  # The f32 proposal trunk (the density head alone, 504 columns, kin 512):
  # K1 on trunk_wide_tf32.cu (214,560 B a CTA: no relu' bits, as the
  # defaults' K1), first-order K4 on trunk_wide_bwd_tf32.cu (220,200 B at
  # depth 4, 228,392 at depth 8), both within an H100's shared memory,
  # counted under 'K1 wide' / 'K4 wide'; nothing is missing.
  _, _, _, pack = _case(1, depth, n=4)
  assert pack.kin == 512 and pack.skip == SKIP[depth] and pack.wc is None
  assert fused_mlp.wide_input(pack) and fused_mlp.missing_instance(
      pack, 0) is None
  assert fused_mlp.wide_tf32(pack) and fused_mlp.wide_tf32_bwd(pack)
  libs = (fused_mlp.forward_library(pack), fused_mlp.backward_library(pack))
  assert libs == (fused_mlp.WIDE_TF32_LIBRARY,
                  fused_mlp.WIDE_TF32_BWD_LIBRARY)
  smem = tuple(fused_mlp.kernel_smem(lib, pack, 0) for lib in libs)
  assert smem == (214560, {4: 220200, 8: 228392}[depth])
  assert max(smem) <= fused_mlp.SMEM_LIMIT
  modes = (False, None, fused_mlp.DirModes(), fused_mlp.SpaModes())
  assert fused_mlp.launch_keys('K1', pack, *modes) == ['K1', 'K1 wide']
  assert fused_mlp.launch_keys('K4', pack, *modes) == ['K4', 'K4 wide']
  assert fused_mlp._kernel_for(pack, 0, 'on')


@pytest.mark.parametrize('case', ['the density gradient', 'head 128',
                                  'an f32 head', 'bf16'])
def test_prop_shapes_beside_it_keep_their_routes(case):
  # Only K1 and first-order K4 of the f32 trunk at the density head alone
  # moved: with the density gradient (the fold: K3, and K4 with u's
  # cotangent) it stays on trunk_fwd_f32.cu / trunk_bwd_f32.cu, as do the
  # 128-wide head and an f32 head beside the density head; bf16 stays on
  # trunk_fwd_tma.cu / trunk_bwd_tma.cu.
  _, _, _, pack = _case(2, 4, n=4)
  fold, hc = None, 0
  if case == 'the density gradient':
    fold = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, NB))
  elif case == 'head 128':
    pack, hc = pack._replace(wc=torch.zeros(128, 256), wct=torch.zeros(
        256, 128), bc=torch.zeros(128)), 128
  elif case == 'an f32 head':
    pack = pack._replace(wh=torch.zeros(3, 256), bh=torch.zeros(3))
  else:
    pack = pack._replace(w=pack.w.bfloat16(), wt=pack.wt.bfloat16(),
                         b=pack.b.bfloat16(), compute_dtype='bfloat16')
  cdt = pack.compute_dtype
  assert fused_mlp.wide_input(pack, fold=fold)
  assert not fused_mlp.wide_tf32(pack, fold=fold)
  assert not fused_mlp.wide_tf32_bwd(pack, fold=fold)
  assert (fused_mlp.forward_library(pack, fold=fold),
          fused_mlp.backward_library(pack, fold=fold)) == (
              fused_mlp.FWD_LIBRARY[cdt], fused_mlp.BWD_LIBRARY[cdt])
  assert fused_mlp.missing_instance(pack, hc, fold) is None


# ------------------------------------------- the panels, in exact f32


@pytest.mark.parametrize('depth', [4, 8])
def test_prop_k1_panels_hold_every_product_of_the_trunk(depth):
  # K1's panels at the density head alone (`tf32_panel_index(..., dg=False,
  # head=False)`: 5 of 256 x 256 at depth 4, 11 at depth 8 with the skip at
  # layer 5; each segment padded to 256, K permuted within every 8; the
  # first of the defaults' K1 panels, without the bottleneck's) run in the
  # kernel's order in exact f32: sigma within 1e-6 of the largest entry of
  # trunk_reference's at depth 4, 2e-6 at depth 8 (there each of the two
  # f32 orders sits 0.6-1.2e-6 from the float64 sigma on three seeds: the
  # rounding of eight layers of sums, not the panels).
  _, _, segs, pack = _case(3, depth)
  count = {4: 5, 8: 11}[depth]
  idx = fused_mlp.tf32_panel_index(depth, SKIP[depth], 512, 252, dg=False,
                                   head=False)
  assert idx.shape == (count * 256, 256) and idx.max() < pack.w.numel()
  np.testing.assert_array_equal(idx, fused_mlp.tf32_panel_index(
      depth, SKIP[depth], 512, 252, dg=False)[:count * 256])
  got = _k1h0_model(pack, segs, lambda a, b: a @ b)
  ws, bs, kw = fused_mlp.unpack_trunk(pack)
  want, = fused_mlp.trunk_reference(segs, ws, bs, **kw)
  bound = {4: 1e-6, 8: 2e-6}[depth]
  assert float((got - want).abs().max() / want.abs().max()) < bound


@pytest.mark.parametrize('depth', [4, 8])
def test_prop_k4_panels_hold_every_product_of_the_backward(depth):
  # First-order K4's panels at the density head alone
  # (`tf32_bwd_panel_index(..., head=False)`: the recompute's and the
  # reverse's, 8 at depth 4 and 18 at depth 8, no head panel) run in the
  # kernel's order in exact f32, zeta_{L-1} an outer product: every weight
  # and bias gradient and dwd within 1e-6 of the largest entry of the
  # port's plain f32 backward (trunk_backward_reference).
  _, sbar, segs, pack = _case(4, depth)
  count = {4: 8, 8: 18}[depth]
  idx = fused_mlp.tf32_bwd_panel_index(depth, SKIP[depth], 512, 252, False,
                                       head=False)
  assert idx.shape == (count * 256, 256) and idx.max() < pack.w.numel()
  _, dws, dbs, dwd = _k4h0_model(pack, segs, sbar, lambda a, b: a @ b)
  ws, bs, kw = fused_mlp.unpack_trunk(pack)
  want = fused_mlp.trunk_backward_reference(segs, ws, bs,
                                            (sbar, None, None, None), **kw)
  assert want[5] is None and want[6] is None  # no dwc, dbc
  for g, w in zip(dws + dbs + [dwd], want[0] + want[1] + [want[2]]):
    assert g.shape == w.shape
    assert float((g - w).abs().max() / w.abs().max()) < 1e-6


# --------------------------------------- the arithmetic, against JAX


@pytest.mark.parametrize('depth', [4, 8])
@pytest.mark.parametrize('passes', [3, 1])
def test_prop_k1_tf32_passes_against_the_f32_bound(passes, depth):
  # The K1 model with the kernel's arithmetic (three TF32 passes, 32-deep
  # f32 slice sums: `_truncated_product`) against JAX
  # reference_encoded_trunk with the density head alone at 64 rows: sigma
  # within KERNEL_BOUND['float32'] of max(1, its largest entry); one pass
  # (hi.hi alone) reads above it.
  case, sbar, segs, pack = _case(5, depth)
  jsig, _ = _jax(case, sbar)
  read = _sigma_read(_k1h0_model(pack, segs, _product(passes)), jsig)
  assert (read < 1) if passes == 3 else (read > 1), read


@pytest.mark.parametrize('depth', [4, 8])
@pytest.mark.parametrize('passes', [3, 1])
def test_prop_k4_tf32_passes_against_the_f32_bounds(passes, depth):
  # The first-order K4 model with the kernel's arithmetic (every product of
  # the tile and of the weight gradients three TF32 passes, each 32-deep
  # slice of K or of the rows summed into a fresh set added in f32) against
  # JAX's gradients of <sbar, sigma> at 64 rows: the recomputed y's sigma
  # within KERNEL_BOUND, every weight and bias gradient and dwd within
  # GRAD_BOUND by relative L2, and within it of the port's plain f32
  # backward too. One pass (hi.hi alone) reads above a bound.
  case, sbar, segs, pack = _case(6, depth)
  jsig, jgrads = _jax(case, sbar)
  y, *got = _k4h0_model(pack, segs, sbar, _product(passes))
  reads = [_sigma_read(y @ pack.wd, jsig)] + _grad_reads(got, jgrads)
  if passes == 1:
    assert max(reads) > 1, reads
    return
  assert max(reads) < 1, reads
  ws, bs, kw = fused_mlp.unpack_trunk(pack)
  want = fused_mlp.trunk_backward_reference(segs, ws, bs,
                                            (sbar, None, None, None), **kw)
  dws, dbs, dwd = got
  for g, w in zip(dws + dbs + [dwd], want[0] + want[1] + [want[2]]):
    assert float((g - w).norm() / w.norm()) < GRAD_BOUND['float32']


@pytest.mark.parametrize('fault', ['head unmasked', 'x padded'])
def test_prop_k4_faults_read_above_the_bound(fault):
  # Two planted faults of the head-0 backward's design read above
  # GRAD_BOUND against JAX with three TF32 passes: zeta_{L-1} = sbar wd
  # without relu'(h_{L-1}) (the outer product that replaced the head's
  # product), and dW_0 read from an x scratch holding each 252-column
  # segment padded to 256 (its first 504 columns, not the real ones).
  case, sbar, segs, pack = _case(7, 4)
  _, jgrads = _jax(case, sbar)
  _, *got = _k4h0_model(pack, segs, sbar, _product(3), faults=[fault])
  assert max(_grad_reads(got, jgrads)) > 1


# ------------------------------------------------- the launch arguments


@pytest.mark.parametrize('depth', [4, 8])
def test_prop_tf32_launch_arguments_match_exports(monkeypatch, depth):
  # The f32 proposal trunk through trunk_kernel and trunk_backward_kernel on
  # CPU tensors, the libraries replaced by _ArgCheck: the forward splits its
  # panels (5 or 11 of 65,536 entries, no wc) and calls
  # refnerf_wide_tf32_k1h0 (100 rows, 252 columns a segment, the depth, the
  # skip, the panels), sigma out alone; the backward splits its panels (8 or
  # 18), calls refnerf_wide_tf32_k4h0 once (100 rows in a 128-row scratch,
  # dwd's two tile sums out of it: no column-sum kernel) and one tn product
  # a layer (zeta's, with the bias partials; no head's), each with the
  # argument list cuda_build.EXPORTS declares; no dwc or dbc comes back.
  from refnerf_tpu_torch.ops import cuda_build
  calls = []
  fake = _ArgCheck(calls)
  monkeypatch.setattr(cuda_build, 'library', lambda name: fake)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda dev: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda dev=None: type('S', (), {'cuda_stream': 0})())
  monkeypatch.setattr(torch.cuda, 'get_device_properties',
                      lambda dev: type('P', (), {
                          'multi_processor_count': 132})())
  _, sbar, segs, pack = _case(8, depth, n=100)
  fwd_np, bwd_np = {4: (5, 8), 8: (11, 18)}[depth]
  out = fused_mlp.trunk_kernel(segs, pack)
  assert [tuple(t.shape) for t in out] == [(100,)]
  assert [fn for fn, _ in calls] == ['refnerf_wide_tf32_split',
                                     'refnerf_wide_tf32_k1h0']
  split, k1 = (args for _, args in calls)
  assert split[0] == fwd_np * 65536 and split[4] is None
  assert k1[:4] == (100, 252, depth, SKIP[depth]) and k1[8] == fwd_np
  del calls[:]
  res = fused_mlp.trunk_backward_kernel(segs, pack, (sbar, None, None, None))
  dws, dbs, dwd, dwh, dbh, dwc, dbc = res[:7]
  assert dwh is dbh is dwc is dbc is None and dwd.shape == (1, 256)
  assert [tuple(t.shape) for t in dws] == [(256, 504)] + [
      (256, 760) if l == SKIP[depth] else (256, 256)
      for l in range(1, depth)]
  names = [fn for fn, _ in calls]
  assert names[0] == 'refnerf_wide_tf32_split' and calls[0][1][0] == (
      bwd_np * 65536)
  k4 = [args for fn, args in calls if fn == 'refnerf_wide_tf32_k4h0']
  assert len(k4) == 1 and 'refnerf_wide_tf32_k4' not in names
  assert k4[0][:5] == (100, 128, 252, depth, SKIP[depth])
  assert k4[0][9] == bwd_np and k4[0][16] is not None
  tn = [args for fn, args in calls if fn == 'refnerf_w1024_tn']
  assert len(tn) == depth and all(a[13] is not None for a in tn)
  assert [a[2] for a in tn] == [512] + [
      768 if l == SKIP[depth] else 256 for l in range(1, depth)]
  assert names.count('refnerf_w1024_colsum') == 0
  # dwd from the kernel's two tile sums: their two stages, 2 groups of 1
  # tile, then the group sums.
  red = [args for fn, args in calls if fn == 'refnerf_reduce']
  first = [i for i, a in enumerate(red) if a[0] == k4[0][16]]
  assert len(first) == 1 and red[first[0]][1:5] == (2, 1, 256, 256)
  assert red[first[0] + 1][1:5] == (1, 1, 256, 256)
  assert red[first[0] + 1][0] == red[first[0]][5]

"""Layer-fused dense trunks: the CUDA kernel wrappers and their plain versions.

Counterpart of refnerf_tpu/ops/pallas/fused_mlp.py in its two forward
serving modes (the Pallas `_fwd_kernel`, fused_mlp.py:612, built per
`TrunkCfg` by `_make_op` :880):

- `fused_encoded_trunk` (K1, the spatial trunk, fused_mlp.py:1326): the IPE
  encoding xs = e sin(m), xc = e cos(m) is made here, outside the kernel
  (:1412-1434); the kernel runs the trunk over the two segments, the density
  head, the f32 head block and the compute-dtype bottleneck head.
- `fused_trunk` (K2, the directional trunk, fused_mlp.py:1178): the trunk over
  [bottleneck, IDE + n.v] and the f32 rgb head.

Both reach one hand-written kernel, `csrc/trunk_fwd.cu` (its header gives
the design). On the H100 it is bound by compute, not memory: a flagship trunk
does ~0.57 TFLOP per 524,288 samples against a few hundred MB of segments in
and heads out, so the tensor-core rate (bf16) or the FMA rate (f32) bounds
it. Weights use nn.Linear's layout,
[out, in]. Each wrapper launches the kernel for CUDA tensors unless
`mode='off'`; a CPU tensor or `mode='off'` takes `trunk_reference`, the plain
PyTorch version written in the Pallas kernel's order of operations:

    h = relu(cdt(f32 sum of segment/activation products) + cdt(bias))
    sigma = f32(y) @ wd,  hf = f32(y) @ wh + bh,  hc = cdt(y @ wc) + cdt(bc)

For a CUDA tensor a wrapper launches its kernel or raises; it never falls
back to the plain version. The backward kernels (Pallas `_bwd_kernel`) are
not ported, so the kernel path refuses inputs that require grad.

Each wrapper counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from refnerf_tpu_torch.ops import mathx

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
MODES = ('auto', 'on', 'off')
_KS = 32  # the kernel streams weights in K-slices of this many rows

Head = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (weight [out, in], bias)


def skip_input_layers(depth: int, skip_period: int) -> Tuple[int, ...]:
  """Layers whose input is [activation, trunk input] (fused_mlp.py:148)."""
  return tuple(i + 1 for i in range(depth)
               if i % skip_period == 0 and 0 < i and i + 1 < depth)


def _check_trunk(depth: int, skip_period: int):
  if depth > 1 and (depth - 1) % skip_period == 0:
    raise NotImplementedError(
        f'a trunk of depth {depth} with skip_layer {skip_period} ends in a '
        'skip concat; the fused trunk does not model it (mlp.py:234-240)')


def encode_ipe(lm, lv, scales, compute_dtype='float32'):
  """The IPE segments (xs, xc) of lifted means/vars [n, nb] (:1412-1434).

  Degree-major, basis-minor columns. The scales are powers of two, so the
  scaling is an exact elementwise multiply; large arguments are range
  reduced as mathx.safe_sin does. Returns two [n, deg * nb] tensors in the
  compute dtype.
  """
  cdt = DTYPES[compute_dtype]
  s = torch.as_tensor(np.asarray(scales, np.float32), device=lm.device)
  n = lm.shape[0]
  m = (lm.float()[:, None, :] * s[:, None]).reshape(n, -1)
  v = (lv.float()[:, None, :] * (s * s)[:, None]).reshape(n, -1)
  m = mathx.safe_trig_arg(m)
  e = torch.exp(-0.5 * v)
  return (e * torch.sin(m)).to(cdt), (e * torch.cos(m)).to(cdt)


def _dot(a, w):
  """a [n, k] @ w [out, k]^T with products and sums in f32."""
  return a.float() @ w.float().t()


def trunk_reference(segs: Sequence[torch.Tensor], weights, biases, *,
                    skip_period: int = 4, wd: Optional[torch.Tensor] = None,
                    head_f32: Optional[Head] = None,
                    head_cdt: Optional[Head] = None,
                    compute_dtype: str = 'float32',
                    activation: Optional[Callable] = None):
  """The plain version of the trunk kernel, in the Pallas order (:566, :628).

  Args:
    segs: input segments [n, d_j]; their concatenation is the trunk input.
    weights, biases: per layer, [width, in] and [width]. The skip layer's
      input columns are [activation, segments] in that order.
    wd: density head weight [1, width]; gives sigma without its bias.
    head_f32: (wh [hf, width], bh [hf]) evaluated in f32.
    head_cdt: (wc [hc, width], bc [hc]) evaluated in the compute dtype.
    activation: the trunk nonlinearity; None is ReLU.

  Returns:
    list [sigma [n]][, hf [n, hf]][, hc [n, hc]].
  """
  cdt = DTYPES[compute_dtype]
  act = torch.relu if activation is None else activation
  width = weights[-1].shape[0]
  bounds = np.cumsum([0] + [int(s.shape[-1]) for s in segs])
  skips = skip_input_layers(len(weights), skip_period)
  segs = [s.to(cdt) for s in segs]

  def seg_sum(w, off):
    hb = _dot(segs[0], w[:, off + bounds[0]:off + bounds[1]])
    for j in range(1, len(segs)):
      hb = hb + _dot(segs[j], w[:, off + bounds[j]:off + bounds[j + 1]])
    return hb

  h = None
  for l, (w, b) in enumerate(zip(weights, biases)):
    if l == 0:
      hb = seg_sum(w, 0)
    else:
      hb = _dot(h, w[:, :width])
      if l in skips:
        hb = hb + seg_sum(w, width)
    h = act(hb.to(cdt) + b.to(cdt))

  outs = []
  y32 = h.float()
  if wd is not None:
    outs.append(y32 @ wd.float().reshape(-1))
  if head_f32 is not None:
    wh, bh = head_f32
    outs.append(y32 @ wh.float().t() + bh.float())
  if head_cdt is not None:
    wc, bc = head_cdt
    outs.append(_dot(h, wc).to(cdt) + bc.to(cdt))
  return outs


class TrunkPack(NamedTuple):
  """A trunk's weights laid out for the kernel: built once per model."""
  w: torch.Tensor             # per layer [width, K_l], K contiguous, flat
  b: torch.Tensor             # [depth, width]
  wd: Optional[torch.Tensor]  # [width] f32
  wh: Optional[torch.Tensor]  # [hf, width] f32
  bh: Optional[torch.Tensor]  # [hf] f32
  wc: Optional[torch.Tensor]  # [hc, width]
  bc: Optional[torch.Tensor]  # [hc]
  seg_dims: Tuple[int, ...]
  kin: int                    # sum(seg_dims) rounded up to the K-slice
  depth: int
  width: int
  skip: int                   # the one skip-input layer, or -1
  compute_dtype: str


def pack_trunk(weights, biases, seg_dims, *, skip_period=4, wd=None,
               head_f32=None, head_cdt=None,
               compute_dtype='float32') -> TrunkPack:
  """Re-lay a trunk's weights for the kernel (the split of `_canonicalize`).

  The segments' weight columns stay contiguous and are zero-padded to
  `kin`, matching the kernel's shared-memory input tile; the skip layer
  keeps its activation columns first.
  """
  cdt = DTYPES[compute_dtype]
  depth, width = len(weights), int(weights[-1].shape[0])
  fin = int(sum(seg_dims))
  kin = -(-fin // _KS) * _KS
  skips = skip_input_layers(depth, skip_period)
  if len(skips) > 1:
    raise NotImplementedError(
        f'the trunk kernel models one skip layer, got {skips}')
  blocks = []
  with torch.no_grad():
    for l, w in enumerate(weights):
      w = w.detach().float()
      k_in = fin if l == 0 else width + (fin if l in skips else 0)
      if tuple(w.shape) != (width, k_in):
        raise ValueError(f'layer {l}: expected weight {(width, k_in)}, '
                         f'got {tuple(w.shape)}')
      if l == 0 or l in skips:
        w = F.pad(w, (0, kin - fin))
      blocks.append(w.reshape(-1))
    f32 = lambda t: None if t is None else t.detach().float().contiguous()
    wh, bh = head_f32 if head_f32 is not None else (None, None)
    wc, bc = head_cdt if head_cdt is not None else (None, None)
    return TrunkPack(
        w=torch.cat(blocks).to(cdt).contiguous(),
        b=torch.stack([b.detach() for b in biases]).to(cdt).contiguous(),
        wd=None if wd is None else f32(wd.reshape(-1)),
        wh=f32(wh), bh=f32(bh),
        wc=None if wc is None else wc.detach().to(cdt).contiguous(),
        bc=None if bc is None else bc.detach().to(cdt).contiguous(),
        seg_dims=tuple(int(d) for d in seg_dims), kin=kin, depth=depth,
        width=width, skip=skips[0] if skips else -1,
        compute_dtype=compute_dtype)


def use_kernel(x: torch.Tensor, mode: str) -> bool:
  """Whether a wrapper launches its kernel for input x under `mode`."""
  if mode not in MODES:
    raise ValueError(f'fused_trunk mode must be one of {MODES}, got {mode!r}')
  return x.is_cuda and mode != 'off'


def _kernel_guard(tensors, activation, n_segs):
  if torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in tensors):
    raise NotImplementedError(
        'the trunk kernels are forward-only: the backward kernels (Pallas '
        '_bwd_kernel) are not ported; run under torch.no_grad()')
  if activation is not None and activation not in (torch.relu, F.relu):
    raise NotImplementedError(
        f'the trunk kernel models ReLU only, got {activation!r}')
  if not 1 <= n_segs <= 2:
    raise NotImplementedError(
        f'the trunk kernel takes one or two input segments, got {n_segs}')


def trunk_kernel(segs: Sequence[torch.Tensor], pack: TrunkPack):
  """Launch the CUDA trunk kernel; outputs as `trunk_reference` returns them."""
  from refnerf_tpu_torch.ops import cuda_build  # builds on first use
  lib = cuda_build.library()
  hc = 0 if pack.wc is None else int(pack.wc.shape[0])
  if not lib.refnerf_trunk_supports(pack.width, hc):
    raise NotImplementedError(
        f'no trunk kernel instance for width {pack.width} and compute-dtype '
        f'head {hc} (built: width 256, head 0 or 128)')
  cdt = DTYPES[pack.compute_dtype]
  dev = segs[0].device
  n = int(segs[0].shape[0])
  dims = tuple(int(s.shape[-1]) for s in segs)
  if dims != pack.seg_dims:
    raise ValueError(f'segments {dims} do not match the pack {pack.seg_dims}')
  for t in (pack.w, pack.b, pack.wd, pack.wh, pack.wc):
    if t is not None and t.device != dev:
      raise ValueError(f'weights on {t.device}, inputs on {dev}')
  segs = [s.to(cdt).contiguous() for s in segs]
  x1 = segs[1] if len(segs) > 1 else None
  hf = 0 if pack.wh is None else int(pack.wh.shape[0])
  sig = torch.empty(n, device=dev) if pack.wd is not None else None
  hout = torch.empty(n, hf, device=dev) if hf else None
  cout = torch.empty(n, hc, device=dev, dtype=cdt) if hc else None
  ptr = lambda t: None if t is None else t.data_ptr()
  with torch.cuda.device(dev):
    err = lib.refnerf_trunk_fwd(
        1 if cdt == torch.bfloat16 else 0, pack.width, hc,
        ptr(segs[0]), dims[0], ptr(x1), dims[1] if x1 is not None else 0,
        n, pack.kin, pack.depth, pack.skip, ptr(pack.w), ptr(pack.b),
        ptr(pack.wd), ptr(pack.wh), ptr(pack.bh), hf, ptr(pack.wc),
        ptr(pack.bc), ptr(sig), ptr(hout), ptr(cout),
        torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f'trunk kernel launch failed with cudaError {err}')
  return [t for t in (sig, hout, cout) if t is not None]


def fused_encoded_trunk(lm, lv, scales, weights, biases, wd, bd=None, *,
                        skip_period=4, head_f32: Optional[Head] = None,
                        head_cdt: Optional[Head] = None,
                        compute_dtype='float32', mode='auto',
                        activation=None, pack: Optional[TrunkPack] = None):
  """K1: the IPE trunk of lifted means/vars lm, lv [..., nb] (:1326).

  `pack` is the kernel's weight layout (pack_trunk); the MLP caches it.
  Without one the kernel path packs on every call.

  Returns (sigma [...], [h_f32 [..., hf],] [h_cdt [..., hc]]), sigma with
  `bd` added (:1460).
  """
  lead = lm.shape[:-1]
  nb = lm.shape[-1]
  n = math.prod(lead)
  _check_trunk(len(weights), skip_period)
  xs, xc = encode_ipe(lm.reshape(n, nb), lv.reshape(n, nb), scales,
                      compute_dtype)
  if use_kernel(xs, mode):
    head_w = [t for h in (head_f32, head_cdt) if h is not None for t in h]
    _kernel_guard([lm, lv, wd, *weights, *biases, *head_w], activation, 2)
    if pack is None:
      pack = pack_trunk(weights, biases, (xs.shape[-1], xc.shape[-1]),
                        skip_period=skip_period, wd=wd, head_f32=head_f32,
                        head_cdt=head_cdt, compute_dtype=compute_dtype)
    outs = trunk_kernel([xs, xc], pack)
    fused_encoded_trunk.launches += 1
  else:
    outs = trunk_reference(
        [xs, xc], weights, biases, skip_period=skip_period, wd=wd,
        head_f32=head_f32, head_cdt=head_cdt, compute_dtype=compute_dtype,
        activation=activation)
  sig = outs[0] if bd is None else outs[0] + bd.float()
  res = [sig.reshape(lead)]
  res += [o.reshape(*lead, o.shape[-1]) for o in outs[1:]]
  return tuple(res)


fused_encoded_trunk.launches = 0


def fused_trunk(segs: Sequence[torch.Tensor], weights, biases, head_f32: Head,
                *, skip_period=4, compute_dtype='float32', mode='auto',
                activation=None, pack: Optional[TrunkPack] = None):
  """K2: a trunk over input segments [..., d_j] and its f32 head (:1178).

  Returns the head output [..., hf]. `pack` as for fused_encoded_trunk.
  """
  lead = segs[0].shape[:-1]
  n = math.prod(lead)
  _check_trunk(len(weights), skip_period)
  flat = [s.reshape(n, s.shape[-1]) for s in segs]
  if use_kernel(flat[0], mode):
    _kernel_guard([*flat, *weights, *biases, *head_f32], activation,
                  len(flat))
    if pack is None:
      pack = pack_trunk(weights, biases, [s.shape[-1] for s in flat],
                        skip_period=skip_period, head_f32=head_f32,
                        compute_dtype=compute_dtype)
    out, = trunk_kernel(flat, pack)
    fused_trunk.launches += 1
  else:
    out, = trunk_reference(
        flat, weights, biases, skip_period=skip_period, head_f32=head_f32,
        compute_dtype=compute_dtype, activation=activation)
  return out.reshape(*lead, out.shape[-1])


fused_trunk.launches = 0

"""The rank's process group and device, and the helpers of data parallelism
(counterpart of refnerf_tpu/parallel/mesh.py:22-98).

The JAX package shards the batch along a 1D 'data' mesh and lets GSPMD (or
shard_map's psum) reduce the gradients. Here each rank is a process of its
own, launched by torchrun:

    python -m torch.distributed.run --nproc_per_node N \
        -m refnerf_tpu_torch.cli.train --gin_configs=... [--dist_backend=nccl]

`initialize_distributed` joins the process group that torchrun's
environment describes and returns it with the rank's device; every helper
here takes that group, and `group=None` means one process (no collective
runs, and every number is what the one-process code gives). The backend is
the caller's: NCCL needs one card a rank, gloo also runs ranks that share a
card (`--device cuda:0`) and ranks on the CPU. A failed init raises; there is
no fallback to another backend or to the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_TORCHRUN = ('RANK', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')


def size(group) -> int:
  """The number of ranks of `group` (1 for None)."""
  return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
  """This process's rank in `group` (0 for None)."""
  return 0 if group is None else dist.get_rank(group)


def is_first(group) -> bool:
  """Whether this process is rank 0 of `group`: the one that writes logs,
  summaries and checkpoints."""
  return rank(group) == 0


def _rank_device(device, local_rank: int, local_world: int,
                 backend: str) -> torch.device:
  device = torch.device(device)
  if device.type != 'cuda':
    return device
  if not torch.cuda.is_available():
    raise RuntimeError(
        f'device {device} asked for, but no CUDA device is available; pass '
        "--device cpu (device='cpu') to run the ranks on the CPU")
  if device.index is None:
    # One card a rank: cuda:LOCAL_RANK.
    if local_rank >= torch.cuda.device_count():
      raise RuntimeError(
          f'LOCAL_RANK {local_rank} has no card: {torch.cuda.device_count()} '
          'visible. Launch at most one rank a card, or name one card for '
          'every rank (--device cuda:0) with the gloo backend.')
    device = torch.device('cuda', local_rank)
  elif backend == 'nccl' and local_world > 1:
    raise ValueError(
        f'every rank named {device}: NCCL needs one card a rank. Use '
        "--device cuda (cuda:LOCAL_RANK) or the gloo backend.")
  torch.cuda.set_device(device)
  return device


def initialize_distributed(device='cuda', backend: Optional[str] = None,
                           timeout_s: float = 1800.0
                           ) -> Tuple[Optional[object], torch.device]:
  """Join the process group of torchrun's environment (RANK, WORLD_SIZE,
  LOCAL_RANK, MASTER_ADDR, MASTER_PORT); returns (group, device).

  Without WORLD_SIZE, or at a world size of 1 with no backend named, this
  is a no-op: (None, device). A half-configured launch raises, as JAX's
  does (mesh.py:45-52): RANK or LOCAL_RANK without WORLD_SIZE, or a world
  size above 1 without every one of RANK, LOCAL_RANK, MASTER_ADDR and
  MASTER_PORT. `backend` defaults to 'nccl' for a CUDA device and 'gloo'
  for the CPU; a named backend also joins a group of one rank. A process
  already in a group of that backend and size reuses it (`destroy` then
  leaves it at the last of the joins). The rank's
  device is cuda:LOCAL_RANK for 'cuda', the card named for 'cuda:K' (every
  rank on it; gloo only), or the CPU.
  """
  env = os.environ
  if 'WORLD_SIZE' not in env:
    stray = [k for k in ('RANK', 'LOCAL_RANK') if k in env]
    if stray:
      raise ValueError(
          f'{" and ".join(stray)} set but WORLD_SIZE is not: a '
          'half-configured launch. Launch with torchrun, or unset them for '
          'one process.')
    return None, torch.device(device)
  world = int(env['WORLD_SIZE'])
  if world < 1:
    raise ValueError(f'WORLD_SIZE {world} must be at least 1')
  if world == 1 and backend is None:
    return None, torch.device(device)
  missing = [k for k in _TORCHRUN if k not in env]
  if missing:
    raise ValueError(
        f'WORLD_SIZE {world} but {", ".join(missing)} not set: a '
        'half-configured launch. Launch with torchrun.')
  if backend is None:
    backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
  if backend not in ('nccl', 'gloo'):
    raise ValueError(f"backend {backend!r} must be 'nccl' or 'gloo'")
  if backend == 'nccl' and torch.device(device).type != 'cuda':
    raise ValueError('the nccl backend needs a CUDA device')
  local_rank = int(env['LOCAL_RANK'])
  local_world = int(env.get('LOCAL_WORLD_SIZE', world))
  dev = _rank_device(device, local_rank, local_world, backend)
  if dist.is_initialized():  # joined already in this process: reused
    if dist.get_backend() != backend or dist.get_world_size() != world:
      raise ValueError(
          f'this process is in a {dist.get_backend()} group of '
          f'{dist.get_world_size()} ranks already, not {backend} of {world}')
    _JOINS[0] += 1
    return dist.group.WORLD, dev
  kwargs = {}
  if backend == 'nccl':
    kwargs['device_id'] = dev
  dist.init_process_group(
      backend, init_method='env://', world_size=world,
      rank=int(env['RANK']), timeout=datetime.timedelta(seconds=timeout_s),
      **kwargs)
  _JOINS[0] = 1
  return dist.group.WORLD, dev


# initialize_distributed's joins of the group not yet left: a second join
# in the same process (a CLI run inside a run of testing/data_parallel.py)
# reuses the group, and only the last `destroy` leaves it.
_JOINS = [0]


def destroy(group) -> None:
  """Leave the process group `initialize_distributed` joined (no-op for
  None; after a reused join, only the last leaves it)."""
  if group is not None:
    _JOINS[0] = max(0, _JOINS[0] - 1)
    if _JOINS[0] == 0:
      dist.destroy_process_group()


def barrier(group) -> None:
  if group is not None:
    dist.barrier(group=group)


def agree(value, group):
  """Rank 0's `value` (a picklable object) on every rank."""
  if group is None:
    return value
  box = [value]
  dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                             group=group)
  return box[0]


def build_kernels(group, device) -> None:
  """Build the CUDA kernels once a node: local rank 0 runs nvcc while the
  others wait at a barrier, so that no two ranks build the same library.
  A no-op off the card."""
  if torch.device(device).type != 'cuda':
    return
  if int(os.environ.get('LOCAL_RANK', '0')) == 0:
    from refnerf_tpu_torch.ops import cuda_build
    cuda_build.build()
  barrier(group)


def round_up_to_multiple(n: int, m: int) -> int:
  return ((n + m - 1) // m) * m


def pad_batch_size(batch_size: int, group) -> int:
  """Batch sizes must divide evenly across the ranks."""
  return round_up_to_multiple(batch_size, size(group))


def rows_of(n: int, rank_: int, world_size: int) -> slice:
  """Rank `rank_`'s rows of `n`: the contiguous slice [r n/N, (r+1) n/N),
  as JAX's P('data') lays a batch over the mesh."""
  if n % world_size:
    raise ValueError(f'{n} rows must divide across {world_size} ranks')
  per = n // world_size
  return slice(rank_ * per, (rank_ + 1) * per)


def shard_rows(n: int, group) -> slice:
  """This rank's rows of `n` (rows_of)."""
  return rows_of(n, rank(group), size(group))


def shard_batch(batch, group):
  """This rank's rows of a global `rays.Batch` (or Rays, Pixels)."""
  if group is None:
    return batch
  rays = getattr(batch, 'rays', batch)
  rows = shard_rows(rays.shape[0], group)
  return batch.map(lambda x: x[rows])


@torch.no_grad()
def replicate(state, group) -> None:
  """Give every rank rank 0's train state, in place: its parameters, its
  Adam moments, count and step."""
  if group is None:
    return
  src = dist.get_global_rank(group, 0)
  for name, p in state.model.named_parameters():
    for t in (p, state.opt.mu[name], state.opt.nu[name]):
      dist.broadcast(t.data, src=src, group=group)
  dev = next(state.model.parameters()).device
  counts = torch.tensor([state.step, state.opt.count], dtype=torch.int64,
                        device=dev)
  dist.broadcast(counts, src=src, group=group)
  state.step, state.opt.count = (int(v) for v in counts.tolist())


class _AllSum(torch.autograd.Function):
  """The sum over the ranks; its backward is the sum of the cotangents over
  the ranks, as JAX's psum transposes. (torch.distributed.nn.functional
  .all_reduce computes the same and is deprecated.)"""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out

  @staticmethod
  def backward(ctx, grad):
    grad = grad.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
    return grad, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
  """The sum of `x` over the ranks, differentiable (_AllSum). The identity
  for group None."""
  if group is None:
    return x
  return _AllSum.apply(x, group)


class _FromFirst(torch.autograd.Function):
  """Rank 0's tensor on every rank. The backward is the transpose: the
  cotangents summed over the ranks go to rank 0, zeros to the others."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out

  @staticmethod
  def backward(ctx, grad):
    grad = grad.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
    if dist.get_rank(ctx.group) != 0:
      grad = torch.zeros_like(grad)
    return grad, None


def from_first(x: torch.Tensor, group) -> torch.Tensor:
  """Rank 0's `x` on every rank, differentiable (JAX's all_gather of the
  shards followed by the first shard, shard_step.py:118-136)."""
  if group is None:
    return x
  return _FromFirst.apply(x, group)


def mean_over_ranks(tensors, group):
  """The mean over the ranks of each tensor of the list, through one
  all-reduce of a flat buffer in the list's order; not differentiable."""
  if group is None:
    return list(tensors)
  tensors = list(tensors)
  flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
  dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
  flat = flat / size(group)
  out, off = [], 0
  for t in tensors:
    out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
    off += t.numel()
  return out

"""The data-parallel train step with explicit collectives (counterpart of
refnerf_tpu/parallel/shard_step.py:51).

Every rank runs train/step.py's step on its rows of the global batch
(parallel.mesh.shard_rows) and its rows of the global batch's draws
(sampling.Draws), then:

  * the plain-mean loss terms (interlevel, distortion, orientation,
    predicted normals, smoothness, acc) are this rank's means, made global
    by the mean over the ranks of the gradients and the stats: exact, since
    the ranks hold equal rows;
  * the masked-mean terms (the data loss, the consistency family, the
    weights entropy) sum their numerator and denominator over the ranks
    inside the loss (losses.py, `group`), so each rank holds the global
    value; their backward all-reduce gives each rank n times its share,
    which the mean over the ranks divides out, as JAX's psum transposes;
  * the consistency rays are the global batch's first rays (rank 0's rows,
    since `sample_noise_size` must fit in one rank's rows): every rank takes
    rank 0's prefix of the rays and of the renderings the losses read,
    through a differentiable broadcast whose backward returns the summed
    cotangents to rank 0 (JAX's all_gather and dynamic slice), and rotates
    and re-renders its slice of them;
  * the gradients, in the order of the parameter names, go through one
    all-reduce of a flat buffer and are divided by the world size; so do the
    stats (shard_step.py:192-194). The clip and Adam then run on every rank
    on the same numbers, so every rank's parameters stay bit-identical.

The model is not wrapped in DistributedDataParallel: the step takes its
gradients with torch.autograd.grad, which never fires DDP's reducer hooks.
With `Config.randomized` a run's numbers depend on the number of ranks only
through the order of its sums (JAX's per-shard `fold_in` draws differ with
the count). The noisy forward's angles are one draw a step, the same on
every rank.
"""

from __future__ import annotations

from refnerf_tpu_torch.parallel import mesh
from refnerf_tpu_torch.train import step as step_lib

# The renderings of the consistency rays that the losses and the ray
# rotation read (shard_step.py:130).
CONSISTENCY_KEYS = ('diffuse', 'specular', 'normals', 'normals_pred',
                    'distance', 'acc')
STAT_KEYS = ('loss', 'mses', 'disparity_mses', 'normal_maes')


class Shard:
  """The collectives of one rank's step (step.make_train_step's `shard`)."""

  def __init__(self, group):
    self.group = group
    self.rank = mesh.rank(group)
    self.world_size = mesh.size(group)

  def consistency_rows(self, rays, renderings, n_noise):
    """This rank's slice of the global batch's first `n_noise` rays and of
    their renderings: (rays, renderings, the slice's length)."""
    rows = mesh.rows_of(n_noise, self.rank, self.world_size)
    take = lambda x: mesh.from_first(x[:n_noise], self.group)[rows]
    c_rays = rays.map(take)
    c_rends = [{k: take(r[k]) for k in CONSISTENCY_KEYS
                if r.get(k) is not None} for r in renderings]
    return c_rays, c_rends, rows.stop - rows.start

  def reduce(self, grads, stats):
    """The gradients and the stats, each averaged over the ranks."""
    names = list(grads)
    grads = dict(zip(names, mesh.mean_over_ranks(
        [grads[k] for k in names], self.group)))
    keys = [k for k in STAT_KEYS if k in stats]
    terms = list(stats['losses'])
    reduced = mesh.mean_over_ranks(
        [stats[k] for k in keys] + [stats['losses'][k] for k in terms],
        self.group)
    stats = dict(stats, **dict(zip(keys, reduced)))
    stats['losses'] = dict(zip(terms, reduced[len(keys):]))
    return grads, stats


def _check_noise_rows(config, world_size):
  """JAX's refusals (shard_step.py:70-79): the consistency rays must divide
  across the ranks and fit in rank 0's rows."""
  if not (step_lib._consistency_enabled(config) or
          step_lib._distance_consistency_enabled(config)):
    return
  n_noise = config.sample_noise_size // config.patch_size**2
  if config.sample_noise_size % world_size or n_noise % world_size:
    raise ValueError(
        f'sample_noise_size {config.sample_noise_size} must divide across '
        f'{world_size} shards.')
  if config.sample_noise_size * world_size > config.batch_size:
    raise ValueError(
        f'sample_noise_size {config.sample_noise_size} must fit in one '
        f'shard (batch_size {config.batch_size} / {world_size} shards) so '
        'the global consistency-ray prefix can be gathered in one hop.')


def make_sharded_train_step(model, config, group=None, raycast_fn=None,
                            noise_angles=None, draws=None):
  """train_step(state, batch, cameras=None) -> (state, stats) of one rank,
  `batch` its rows of the global batch (mesh.shard_batch). The state must
  start equal on every rank (mesh.replicate). `group=None` is
  step.make_train_step. The step's `loss_and_grads` returns the reduced
  loss, stats and gradients before the clip."""
  if group is None:
    return step_lib.make_train_step(model, config, raycast_fn, noise_angles,
                                    draws)
  world = mesh.size(group)
  if config.batch_size % world:
    raise ValueError(
        f'batch_size {config.batch_size} must divide across {world} devices')
  _check_noise_rows(config, world)
  return step_lib.make_train_step(model, config, raycast_fn, noise_angles,
                                  draws, shard=Shard(group))

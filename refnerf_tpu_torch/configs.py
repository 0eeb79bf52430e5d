"""Configuration for the port: the Config fields it reads, parsed with ginlite.

Counterpart of refnerf_tpu/configs.py:33-218. That module cannot be imported
here (it imports absl), so this one holds the fields the port reads, with the
same names and defaults, and parses the same gin files. Bindings of the JAX
Config's other fields are accepted, kept in `Config.unread`, and not used; any
other name raises, as in the JAX package. `load_config` snapshots the merged
gin to `<checkpoint_dir>/logs/<exp prefix>/<exp>/config.gin`, as JAX's
(configs.py:222-231) does, without absl: the CLIs parse their flags with
argparse (`refnerf_tpu_torch/cli/flags.py`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from refnerf_tpu_torch.utils import ginlite

_CONFIGS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'configs')

# Fields of refnerf_tpu.configs.Config that the port does not read yet.
_UNREAD_FIELDS = frozenset('''
num_workers num_gpus gc_every render_dir vocab_tree_path train_render_every
noise_background render_save_async
'''.split())


@dataclasses.dataclass
class Config:
  """The Config fields the port reads (names and defaults of the JAX Config)."""
  # Experiment, checkpoints and the train loop (configs.py:36-80, :84-87).
  exp_name: str = 'exp'
  seed: int = 20230227
  val_sample_num: int = 3
  checkpoint_dir: Optional[str] = None
  num_showcase_images: int = 5
  deterministic_showcase: bool = True
  vis_decimate: int = 0
  save_top_k: int = 5
  resume_path: Optional[str] = None
  early_exit_steps: Optional[int] = None
  checkpoint_every: int = 25000
  print_every: int = 100
  # The eval and render loops (configs.py:150-171).
  eval_only_once: bool = True
  eval_save_output: bool = True
  eval_save_ray_data: bool = False
  eval_render_interval: int = 1
  eval_dataset_limit: int = int(np.iinfo(np.int32).max)
  render_video_fps: int = 60
  render_video_crf: int = 18
  render_dist_percentile: float = 0.5
  render_dist_curve_fn: Callable[..., Any] = np.log
  render_job_id: int = 0
  render_num_jobs: int = 1
  randomized: bool = True
  near: float = 2.0
  far: float = 6.0
  render_chunk_size: int = 16384
  vis_num_rays: int = 16
  srgb_mapping_when_rendering: bool = False
  srgb_mapping_type: str = 'linear'
  render_with_specular_density: bool = False
  # Data (configs.py:42-69): the loaders and the train batches.
  n_input_views: int = 0
  dataset_loader: str = 'llff'
  dataset_debug_mode: bool = False
  batching: str = 'all_images'
  factor: int = 0
  load_alphabetical: bool = True
  forward_facing: bool = False
  render_path: bool = False
  llffhold: int = 8
  llff_use_all_images_for_training: bool = False
  dtuhold: int = 8
  dtu_light_cond: int = 2
  use_tiffs: bool = False
  data_dir: Optional[str] = None
  cast_rays_in_train_step: bool = True
  # Eval metrics (configs.py:150-156) and the render paths (:158-178).
  eval_quantize_metrics: bool = True
  eval_crop_borders: int = 0
  render_path_frames: int = 120
  z_variation: float = 0.0
  z_phase: float = 0.0
  render_path_file: Optional[str] = None
  render_resolution: Optional[Tuple[int, int]] = None
  render_focal: Optional[float] = None
  render_camtype: Optional[str] = None
  render_spherical: bool = False
  render_spline_keyframes: Optional[str] = None
  render_spline_n_interp: int = 30
  render_spline_degree: int = 5
  render_spline_smoothness: float = 0.03
  # Training (configs.py:38-147): the batch, the losses of the train step
  # and the optimizer.
  batch_size: int = 16384
  patch_size: int = 1
  compute_disp_metrics: bool = False
  compute_normal_metrics: bool = False
  disable_multiscale_loss: bool = False
  max_steps: int = 250000
  stats_every: int = 1
  data_loss_type: str = 'charb'
  charb_padding: float = 0.001
  data_loss_mult: float = 1.0
  data_coarse_loss_mult: float = 0.0
  interlevel_loss_mult: float = 1.0
  orientation_loss_mult: float = 0.0
  orientation_coarse_loss_mult: float = 0.0
  orientation_loss_target: str = 'normals_pred'
  predicted_normal_loss_mult: float = 0.0
  predicted_normal_coarse_loss_mult: float = 0.0
  sample_noise_size: int = 128
  # The noisy second forward and its consistency losses (configs.py:42,
  # :102-135).
  sample_angle_range: float = 5
  sample_noise_angles: int = 1
  consistency_warmup_steps: float = 0.0
  consistency_decay_steps: float = 1.0
  consistency_normal_loss_target: str = 'normals_pred'
  consistency_diffuse_loss_type: str = 'mse'
  consistency_specular_loss_type: str = 'mse'
  consistency_distance_loss_type: str = 'mse'
  acc_threshold_for_consistency_loss: float = 0.0
  acc_threshold_for_weights_entropy_loss: float = 0.0
  consistency_normal_loss_mult: float = 0.0
  consistency_normal_coarse_loss_mult: float = 0.0
  consistency_diffuse_loss_mult: float = 0.0
  consistency_diffuse_coarse_loss_mult: float = 0.0
  consistency_specular_loss_mult: float = 0.0
  consistency_specular_coarse_loss_mult: float = 0.0
  accumulated_weights_loss_mult: float = 0.0
  supervised_by_linear_rgb: bool = False
  depth_smoothness_loss_mult: float = 0.0
  depth_smoothness_coarse_loss_mult: float = 0.0
  consistency_distance_loss_mult: float = 0.0
  consistency_distance_coarse_loss_mult: float = 0.0
  weights_entropy_loss_mult: float = 0.0
  weights_entropy_coarse_loss_mult: float = 0.0
  lr_init: float = 0.002
  lr_final: float = 0.00002
  lr_delay_steps: int = 512
  lr_delay_mult: float = 0.01
  adam_beta1: float = 0.9
  adam_beta2: float = 0.999
  adam_eps: float = 1e-6
  grad_max_norm: float = 0.001
  grad_max_val: float = 0.0
  distortion_loss_mult: float = 0.01
  # Bindings of JAX Config fields the port does not read yet.
  unread: Dict[str, Any] = dataclasses.field(default_factory=dict)


def parse(gin_configs, gin_bindings, scope: Optional[str] = None):
  """Parse gin files and bindings; returns (Config, gin)."""
  gin = ginlite.parse_config_files_and_bindings(
      gin_configs, gin_bindings, search_paths=['', 'configs', _CONFIGS_DIR])
  kwargs = gin.get('Config', scope=scope)
  fields = {f.name for f in dataclasses.fields(Config)} - {'unread'}
  unknown = set(kwargs) - fields - _UNREAD_FIELDS
  if unknown:
    raise ValueError(f'Unknown Config fields in gin: {sorted(unknown)}')
  unread = {k: v for k, v in kwargs.items() if k in _UNREAD_FIELDS}
  config = Config(**{k: v for k, v in kwargs.items() if k in fields},
                  unread=unread)
  return config, gin


def exp_dir(config, kind: str) -> str:
  """`<checkpoint_dir>/<kind>/<exp prefix>/<exp>`: the layout of the JAX
  package's logs (kind 'logs') and checkpoints ('ckpt')."""
  return os.path.join(config.checkpoint_dir, kind,
                      config.exp_name.split('_')[0], config.exp_name)


def load_config(gin_configs, gin_bindings, scope: Optional[str] = None,
                save_config: bool = True):
  """Parse the gin files and bindings (as `parse`) and, with `save_config`
  and a `checkpoint_dir`, write the merged config to
  `<checkpoint_dir>/logs/<exp prefix>/<exp>/config.gin`. Returns (Config,
  gin)."""
  config, gin = parse(gin_configs, gin_bindings, scope=scope)
  if save_config and config.checkpoint_dir:
    dirname = exp_dir(config, 'logs')
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, 'config.gin'), 'w') as f:
      f.write(gin.config_str())
  return config, gin


def mlp_kwargs(gin: ginlite.GinConfig, which: str, scope=None):
  """Merged kwargs for NerfMLP or PropMLP (MLP.* as the shared base)."""
  out = gin.get('MLP', scope=scope)
  out.update(gin.get(which, scope=scope))
  return out


def model_kwargs(gin: ginlite.GinConfig, scope=None):
  return gin.get('Model', scope=scope)

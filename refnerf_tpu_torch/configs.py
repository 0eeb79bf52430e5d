"""Configuration for the port: the Config fields it reads, parsed with ginlite.

Counterpart of refnerf_tpu/configs.py:33-218. That module cannot be imported
here (it imports absl), so this one holds the fields the port reads, with the
same names and defaults, and parses the same gin files. Bindings of the JAX
Config's other fields are accepted, kept in `Config.unread`, and not used; any
other name raises, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from refnerf_tpu_torch.utils import ginlite

_CONFIGS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'configs')

# Fields of refnerf_tpu.configs.Config that the port does not read yet.
_UNREAD_FIELDS = frozenset('''
exp_name num_workers num_gpus val_sample_num sample_angle_range n_input_views
dataset_loader dataset_debug_mode batching factor load_alphabetical
forward_facing render_path llffhold llff_use_all_images_for_training dtuhold
dtu_light_cond use_tiffs gc_every checkpoint_dir render_dir data_dir
vocab_tree_path num_showcase_images deterministic_showcase vis_decimate
save_top_k resume_path early_exit_steps checkpoint_every print_every
train_render_every cast_rays_in_train_step sample_noise_angles
consistency_warmup_steps consistency_decay_steps
consistency_normal_loss_target consistency_diffuse_loss_type
consistency_specular_loss_type noise_background consistency_distance_loss_type
acc_threshold_for_consistency_loss acc_threshold_for_weights_entropy_loss
eval_only_once eval_save_output eval_save_ray_data eval_render_interval
eval_dataset_limit eval_quantize_metrics eval_crop_borders render_video_fps
render_video_crf render_path_frames z_variation z_phase render_dist_percentile
render_dist_curve_fn render_path_file render_job_id render_num_jobs
render_resolution render_focal render_camtype render_spherical
render_save_async render_spline_keyframes render_spline_n_interp
render_spline_degree render_spline_smoothness
'''.split())


@dataclasses.dataclass
class Config:
  """The Config fields the port reads (names and defaults of the JAX Config)."""
  seed: int = 20230227
  randomized: bool = True
  near: float = 2.0
  far: float = 6.0
  render_chunk_size: int = 16384
  vis_num_rays: int = 16
  srgb_mapping_when_rendering: bool = False
  srgb_mapping_type: str = 'linear'
  render_with_specular_density: bool = False
  # Training (configs.py:38-147): the batch, the losses of the train step
  # and the optimizer. Losses the port does not compute are read so that the
  # train step can refuse a nonzero multiplier.
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


def mlp_kwargs(gin: ginlite.GinConfig, which: str, scope=None):
  """Merged kwargs for NerfMLP or PropMLP (MLP.* as the shared base)."""
  out = gin.get('MLP', scope=scope)
  out.update(gin.get(which, scope=scope))
  return out


def model_kwargs(gin: ginlite.GinConfig, scope=None):
  return gin.get('Model', scope=scope)

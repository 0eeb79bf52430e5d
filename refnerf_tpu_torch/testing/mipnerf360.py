"""mip-NeRF 360's published model as gin bindings (no gin file).

multinerf's `configs/360.gin` on the MLP's and the Model's own defaults:
three levels (two proposal levels of 64 samples on a separate density-only
PropMLP of 4 x 256, then 32 NeRF samples), weight dilation between the
levels, Schlick annealing and single-jitter stratified sampling, the
reciprocal ray-distance warp from near 0.2 to far 1e6 with an opaque
background, and the scene contraction bound as both MLPs' `warp_fn`. The
NeRF MLP is 8 x 1024 (the skip at layer 5) on the default encoding (the
icosahedron basis at 2 subdivisions, degrees 0-11: 504 IPE columns), with
the 256-wide bottleneck and a directional trunk of 1 x 128 on [bottleneck |
positional encoding of degree 4] (283 columns). Losses: data, interlevel
1.0 and distortion 0.01; the normal losses at 0, as JAX's loss loops read
every level's normals and the published MLPs have none. Batch 16,384 rays,
the Config default.

Parse them without a gin file (`configs.parse([], MIPNERF360)`); the
tests cut them to narrow widths with later bindings, and chip_smoke.py
phase 24 runs them at full width.
"""

MIPNERF360 = [
    'Model.num_levels = 3', 'Model.single_mlp = False',
    'Model.num_prop_samples = 64', 'Model.num_nerf_samples = 32',
    'Model.anneal_slope = 10.', 'Model.dilation_bias = 0.0025',
    'Model.dilation_multiplier = 0.5', 'Model.single_jitter = True',
    'Model.resample_padding = 0.', 'Config.randomized = True',
    'Model.raydist_fn = @jnp.reciprocal', 'Model.opaque_background = True',
    'Config.near = 0.2', 'Config.far = 1e6',
    'Config.interlevel_loss_mult = 1.0', 'Config.distortion_loss_mult = 0.01',
    'Config.orientation_loss_mult = 0.',
    'Config.orientation_coarse_loss_mult = 0.',
    'Config.predicted_normal_loss_mult = 0.',
    'Config.predicted_normal_coarse_loss_mult = 0.',
    'PropMLP.net_depth = 4', 'PropMLP.net_width = 256',
    'PropMLP.disable_rgb = True', 'PropMLP.disable_density_normals = True',
    'PropMLP.warp_fn = @coord.contract',
    'NerfMLP.net_depth = 8', 'NerfMLP.net_width = 1024',
    'NerfMLP.disable_density_normals = True',
    'NerfMLP.warp_fn = @coord.contract',
    'Config.batch_size = 16384',
]

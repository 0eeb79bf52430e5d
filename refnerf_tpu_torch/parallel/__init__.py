"""Data parallelism over torch.distributed (counterpart of
refnerf_tpu/parallel/): the rank's process group and device, the batch and
state helpers and the differentiable collectives (`mesh.py`), and the
explicitly reduced train step (`shard_step.py`)."""

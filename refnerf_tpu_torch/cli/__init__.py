"""The port's command lines: `python3 -m refnerf_tpu_torch.cli.train`,
`.eval` and `.render`, each with the JAX CLIs' flags (`flags.py`)."""

"""Host utilities of the port: `ginlite`, the gin parser (a copy of
refnerf_tpu/utils/ginlite.py, which needs only the standard library)."""

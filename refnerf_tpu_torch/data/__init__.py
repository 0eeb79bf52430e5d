"""Scene datasets, COLMAP poses and the host-to-device batch pipeline."""

"""Scripts that measure the port on the card (run with python3 -m)."""

"""Scripts that measure the port on the card, and the analytic test scene
(run with python3 -m)."""

"""Ray containers."""

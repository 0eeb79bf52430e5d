"""Ray containers, camera poses and ray casting."""

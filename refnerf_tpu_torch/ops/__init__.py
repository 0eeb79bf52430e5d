"""Math ops of the port: plain PyTorch, plus the fused trunk kernels."""

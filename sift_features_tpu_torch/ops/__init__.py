"""Operations of the port: plain PyTorch versions and the kernel wrappers."""

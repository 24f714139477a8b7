"""Per-block device ops of the port: plain PyTorch versions and the
wrappers of their CUDA kernels (motion search, MC, transforms, TU coding,
the intra prediction bank, SATD and the intra TU trial)."""

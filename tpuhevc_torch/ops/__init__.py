"""Per-block ops of the port: plain PyTorch versions and the wrappers of
their CUDA kernels (motion search, MC and the B prediction, transforms,
TU coding, the intra prediction bank, SATD, the intra TU trial and the
wavefront intra coding of whole pictures), the
numpy host versions the coding walks and the decoder use, and the
in-loop filters (deblocking, SAO)."""

"""tpuhevc_torch — the PyTorch/CUDA port of tpuhevc for NVIDIA Hopper.

A second package beside `tpuhevc` (the JAX reference, which it never
edits). It imports the jax-free host side of `tpuhevc` (configuration,
the intra coding walk, the P decision walk, CABAC, NAL packing, the
decoder) and replaces the device stages with PyTorch glue around
hand-written CUDA kernels built for sm_90a (`kernels/csrc`).

Ported so far, driven by `codec/encoder.py:encode_sequence`: the
open-loop quadtree intra decision (`codec/intra_decide.py`, the twin of
`tpuhevc.codec.intra_decide_jax`), which decides every all-intra picture
and the LD-P IDR; and the LD-P NN-FME chunked scan (`codec/inter_batch.py`,
the twin of `tpuhevc.codec.inter_batch.build_ldp_scan`). Every kernel has
a plain PyTorch version beside it; a wrapper uses the plain version only
for tensors on the CPU and launches its kernel (or raises) for CUDA
tensors.
"""

__version__ = "0.2.0"

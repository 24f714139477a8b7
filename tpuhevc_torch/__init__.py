"""tpuhevc_torch — the PyTorch/CUDA port of tpuhevc for NVIDIA Hopper.

A second package beside `tpuhevc` (the JAX reference, which it never
edits and never imports). It carries its own numpy copy of the host side
it runs, laid out as the reference lays it out (configuration and
parameters, the intra coding walk, the P and B decision walks, CABAC,
headers and NAL packing, the in-loop filters, the decoder, and the
ctypes binding of `native/libtpuhevc_entropy.so`), and replaces the
device stages with PyTorch glue around hand-written CUDA kernels built
for sm_90a (`kernels/csrc`).

Ported so far, driven by `codec/encoder.py:encode_sequence`: the
open-loop quadtree intra decision (`codec/intra_decide.py`, the twin of
`tpuhevc.codec.intra_decide_jax`), which decides every all-intra picture
and every IDR; fixed-8x8 intra pictures coded whole on the device over
dependency wavefronts (`codec/intra_frame.py`, the twin of
`tpuhevc.codec.intra_jax`); the LD-P NN-FME chunked scan (`codec/inter_batch.py`, the
twin of `tpuhevc.codec.inter_batch.build_ldp_scan`); and random access:
the B step (`codec/inter_b.py`, twin of `inter_b._b_step`) and the
per-frame P stage (`codec/inter_enc.py`, twin of `inter_enc._stage_fn`)
under the GOP-table driver; Main10 on the all-intra and LD-P routes off
the grid (K1, K3, K4 and intra_txq in 10-bit variants). Every kernel has a plain PyTorch version
beside it; a wrapper uses the plain version only for tensors on the CPU
and launches its kernel (or raises) for CUDA tensors.
"""

__version__ = "0.3.0"

"""Scale-out of the port: a mesh of devices driven by one process, row
stripes with explicit halo copies, and IDR-led segments encoded on their
own devices (the counterpart of `tpuhevc/parallel/`).

- `mesh.py`: `make_mesh` / `Mesh`, `tile_prescreen` (kernel
  `stripe_prescreen`, one launch a device over the stripes it holds),
  `stripe_refine` (kernel `grid_refine` per stripe, reading its halos
  through `ry_y0`) and `sharded_frame_step` (the whole grid step on
  64-row stripes, `stripe_rows`, through the exchanges of
  `codec/stripes.py`);
- `segments.py`: `split_segments`, `encode_segments_parallel`,
  `encode_segments_overlapped`;
- `dryrun.py`: `dryrun_multichip`, the graft entry's multi-device steps
  (2, 2b, 2c, 3).
"""

"""tpuhevc's grid build cache and the port's tests (`fresh_grid`).

tpuhevc's `build_ldp_grid_scan` registers its stage probes
(`inter_grid._PROBES`) only when it builds, not on a cache hit, and its
`parallel.mesh.stripe_refine` and `sharded_frame_step` read them right
after a build. A port test that left a cache entry behind made a later
tpuhevc call in the same process read another build's probes:
`tests/test_parallel.py::test_stripe_refine_bit_exact` then failed with
"H must split into 16-aligned row stripes". The port's tests call the
builders through `torch_port_util.fresh_grid`, which empties the cache
before and after. Each case here takes the failing sequence in one
process: tpuhevc's mesh function through the helper (as the port's
tests call it), a 128x80 grid build through the helper, then tpuhevc's
own mesh function at the first configuration, which must build afresh
and read its own probes.
"""

import pytest

from torch_port_util import fresh_grid
from tpuhevc.codec import inter_grid as jg
from tpuhevc.codec.params import EncoderConfig, SeqParams
from tpuhevc.parallel import mesh


def cfg(w, h, **kw):
    """tests/test_parallel.py's configurations, at w x h."""
    args = dict(qp=32, intra_period=-1, fme_mode="none", num_ref_frames=1,
                search_range=16, inter_backend="jax")
    args.update(kw)
    return EncoderConfig(sps=SeqParams(width=w, height=h,
                                       max_tu_depth_intra=0), **args)


@pytest.mark.parametrize("name, w, h, n, kw", [
    ("stripe_refine", 128, 384, 8, {}),
    ("sharded_frame_step", 128, 128, 2,
     dict(num_ref_frames=2, deblocking=True)),
])
def test_mesh_reads_its_own_build_after_port_calls(name, w, h, n, kw):
    fn = getattr(mesh, name)
    _, first = fresh_grid(fn, cfg(w, h, **kw), {32: None}, mesh.make_mesh(n))
    assert first["meta"]["H"] == h
    _, other = fresh_grid(jg.build_ldp_grid_scan, cfg(128, 80), {32: None}, 1)
    assert other["meta"]["H"] == 80
    assert not jg._BUILD_CACHE
    try:
        out = fn(cfg(w, h, **kw), {32: None}, mesh.make_mesh(n))
        assert jg._PROBES["meta"]["H"] == h
        if name == "stripe_refine":
            assert out[2] == 40  # the halo of SearchRange 16
        else:
            assert out[2]["H"] == h
    finally:
        jg._BUILD_CACHE.clear()

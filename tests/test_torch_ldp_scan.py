"""The LD-P slice as a whole: tpuhevc_torch's LD-P NN-FME scan against
tpuhevc's (JAX on the CPU) at 112x72, where JAX itself takes
inter_batch.build_ldp_scan (the size is not 16-aligned).

- one 8-frame chunk from the same IDR references gives byte-identical
  packed rows (and per class, K1's mv/sad9 and K2's offsets equal the JAX
  stage's);
- five frames end to end give a bitstream byte-identical to tpuhevc's
  default (jax-backend) encode, whose IDR is decided on the device as the
  port's is, and tpuhevc's decoder decodes it with every hash OK and the
  encoder's recon;
- the port imports no jax, never falls back to the CPU, and refuses
  configurations outside the slice; the ones that the per-picture P path
  admits (RDOQ, sign hiding, deblocking, SAO, DCT-IF, rate control,
  IntraPeriod 8) encode on the CPU and decode with every hash OK.
"""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    QP, GOP_QP_OFFSETS, H, W, Reader, clip_frames, cuda_device, ldp_cfg,
    parse_meta, write_weights)
from tpuhevc.codec import inter_batch as jib
from tpuhevc.codec.decoder import decode_stream
from tpuhevc.codec.encoder import encode_sequence as jax_encode_sequence
from tpuhevc.codec.params import p_frame_lambda
from tpuhevc.models import nnfme as ref_nnfme
from tpuhevc_torch.codec import inter_batch as tib
from tpuhevc_torch.codec.decoder import decode_stream as port_decode
from tpuhevc_torch.codec.encoder import encode_sequence
from tpuhevc_torch.codec.intra_qt import encode_frame_intra_qt
from tpuhevc_torch.kernels import LAUNCHES, reset_launches
from tpuhevc_torch.models.nnfme import (
    NNFME, height_category, nn_refine, random_params, width_category)
from tpuhevc_torch.ops.interp import mc_blk
from tpuhevc_torch.ops.me import bits_table, sad_search
from tpuhevc_torch.ops.txq import txq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["c32", "c16", "cf", "c8"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    npz = write_weights(tmp_path_factory.mktemp("nnfme") / "w.npz")
    return npz, clip_frames(W, H, 9)


@pytest.fixture(scope="module")
def chunk(setup):
    """One 8-frame chunk (2 GOPs of 4) through both scans, from the IDR
    recon of frame 0. n_gops=2 and the weights path match the end-to-end
    test, so the JAX scan compiles once per module."""
    import jax.numpy as jnp

    npz, frames = setup
    cfg = ldp_cfg(npz)
    params = ref_nnfme.select_qp_params(ref_nnfme.load_npz(npz), QP)
    qps = sorted({min(max(QP + o, 0), 51) for o in GOP_QP_OFFSETS})
    nn_by_qp = {qp: params for qp in qps}
    tcfg = ldp_cfg(npz, port=True)
    _, refs = encode_frame_intra_qt(*frames[0], tcfg, device="cpu")
    refs = [np.ascontiguousarray(p, dtype=np.int32) for p in refs]
    u8 = np.stack([np.concatenate([p.ravel() for p in fr])
                   for fr in frames[1:9]]).reshape(2, 4, -1)
    jfn, _, jqps = jib.build_ldp_scan(cfg, nn_by_qp, 2)
    jout = jfn(jnp.asarray(u8), *[jnp.asarray(p) for p in refs])
    tfn, _, tqps = tib.build_ldp_scan(tcfg, nn_by_qp, 2, "cpu")
    tout = tfn(torch.from_numpy(u8), *[torch.from_numpy(p) for p in refs])
    assert jqps == tqps
    return dict(cfg=cfg, frames=frames, refs=refs, params=params, qps=jqps,
                jax=[np.asarray(x) for x in jout],
                torch=[x.numpy() for x in tout])


def test_packed_rows_byte_identical(chunk):
    jrows, trows = chunk["jax"][0], chunk["torch"][0]
    assert trows.dtype == np.uint8 and trows.shape == jrows.shape
    assert trows.shape[1] == jib.frame_bytes(chunk["cfg"])
    for j in range(len(jrows)):
        assert trows[j].tobytes() == jrows[j].tobytes(), f"frame {j}"
    for a, b in zip(chunk["torch"][1:], chunk["jax"][1:]):  # carried recon
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tag", CLASSES)
def test_stages_match_jax_per_class(chunk, tag):
    """K1 (mv_int, sad9) and K1+K2 (quarter-pel mvq) of the first frame of
    the chunk, recomputed by the port's ops from the same inputs, equal the
    JAX stage outputs packed in its row."""
    cfg = chunk["cfg"]
    tags = {t: (poss, size) for t, poss, size in jib._positions(cfg)[1]}
    poss, size = tags[tag]
    sr = min(cfg.search_range, 16)
    lam_full = int(round(p_frame_lambda(cfg, 0, chunk["qps"][0]) * 256))
    lam_me = int(round(np.sqrt(lam_full / 256.0) * 256))
    cur = chunk["frames"][1][0].astype(np.int32).reshape(-1)[
        jib._blk_idx(poss, size, W)]
    xs = torch.tensor([p[0] for p in poss], dtype=torch.int32)
    ys = torch.tensor([p[1] for p in poss], dtype=torch.int32)
    mv, sad9 = sad_search(torch.from_numpy(chunk["refs"][0].astype(np.int32)),
                          torch.from_numpy(cur), xs, ys,
                          bits_table(sr, "cpu"), lam_me, sr, bit_depth=8)
    _, _, qoff = nn_refine(NNFME.from_numpy(chunk["params"], "cpu"), sad9,
                           height_category(size), width_category(size))
    mvq_j, mv_j, sad9_j, _ = parse_meta(cfg, chunk["jax"][0][0])[tag]
    np.testing.assert_array_equal(mv.numpy(), mv_j)
    np.testing.assert_array_equal(sad9.numpy(), sad9_j)
    np.testing.assert_array_equal((mv * 4 + qoff).numpy(), mvq_j)


def test_e2e_bitstream_matches_jax_and_decodes(setup):
    npz, frames = setup
    enc_j, _ = jax_encode_sequence(Reader(frames), ldp_cfg(npz), max_frames=5)
    enc_t, recons = encode_sequence(Reader(frames), ldp_cfg(npz, port=True),
                                    max_frames=5, device="cpu")
    stream = enc_t.bitstream()
    assert stream == enc_j.bitstream()
    # fractional MVs really came from NN-FME (weights present and used)
    assert enc_t.nn_params is not None
    decoded = decode_stream(stream)
    assert [f.poc for f in decoded] == list(range(5))
    assert all(f.md5_ok for f in decoded)
    for f in decoded:
        ry, ru, rv = recons[f.poc]
        np.testing.assert_array_equal(f.y, ry[:H, :W])
        np.testing.assert_array_equal(f.u, ru[: H // 2, : W // 2])
        np.testing.assert_array_equal(f.v, rv[: H // 2, : W // 2])


def test_port_imports_no_jax(tmp_path):
    """In a fresh interpreter: import the port, encode three frames, and
    jax must not have been imported."""
    code = f"""
import sys
sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tests')!r}]
import tpuhevc_torch, tpuhevc_torch.app
from tpuhevc_torch.codec.encoder import encode_sequence
from torch_port_util import Reader, clip_frames, ldp_cfg, write_weights
npz = write_weights({str(tmp_path / 'w.npz')!r})
enc, _ = encode_sequence(Reader(clip_frames(112, 72, 3)),
                         ldp_cfg(npz, port=True), device="cpu")
assert len(enc.results) == 3
print("jax loaded:", "jax" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path),
                         # one intra-op thread: faster at these sizes
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "jax loaded: False"


def test_no_fallback_without_cuda(monkeypatch, setup):
    npz, frames = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_sequence(Reader(frames), ldp_cfg(npz, port=True),
                        max_frames=3, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tib.build_ldp_scan(ldp_cfg(npz, port=True), {}, 1, "cuda")


def test_wrappers_refuse_non_cpu_tensors_they_cannot_launch():
    """A tensor off the CPU never takes the plain path: the wrapper
    launches its kernel or raises."""
    meta = torch.device("meta")
    i32 = dict(dtype=torch.int32, device=meta)
    model = NNFME.from_numpy(random_params(0), "cpu").to(meta)
    calls = [
        lambda: sad_search(torch.empty(40, 40, **i32),
                           torch.empty(2, 8, 8, **i32), torch.empty(2, **i32),
                           torch.empty(2, **i32), torch.empty(33, 33, **i32),
                           0, 16, bit_depth=8),
        lambda: nn_refine(model, torch.empty(2, 9, **i32), 2, 2),
        lambda: mc_blk(torch.empty(8, 8, **i32), torch.empty(2, **i32),
                       torch.empty(2, **i32), torch.empty(2, 2, **i32), 8,
                       True),
        lambda: txq(torch.empty(2, 8, 8, **i32), torch.empty(2, 8, 8, **i32),
                    32, 1000),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()


OUTSIDE = {
    "rdoq": dict(rdoq=True),
    "sbh": dict(sbh=True),
    "deblocking": dict(deblocking=True),
    "sao": dict(sao=True),
    "dctif": dict(fme_mode="dctif"),
    "random_access": dict(gop_structure="ra"),
    "rate_control": dict(target_bitrate=200000),
    "intra_period_8": dict(intra_period=8),
    "bit_depth_10": dict(bit_depth=10),
    # random access takes whole 16x16 blocks: 112x64
    "bit_depth_10_random_access": dict(bit_depth=10, gop_structure="ra",
                                       h=64),
    "bit_depth_10_weighted_pred": dict(bit_depth=10, wp=True),
    "scaling_list": dict(scaling_list=True),
}
# admitted since the per-picture P path with the host tool stage, bit
# depth 10 since Main10 on the LD-P routes off the grid, and in random
# access since Main10 there: these encode and decode hash-OK
ADMITTED = {"rdoq", "sbh", "deblocking", "sao", "dctif", "rate_control",
            "intra_period_8", "bit_depth_10", "bit_depth_10_random_access"}
# refused by name
NAMED = {"bit_depth_10_weighted_pred": "weighted prediction at bit depth 10"}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_outside_slice_raises(setup, name):
    npz, frames = setup
    kw = dict(OUTSIDE[name])
    sps_kw = {}
    if kw.pop("sao", False):
        sps_kw["sao_enabled"] = True
    if "bit_depth" in kw:
        sps_kw["bit_depth"] = kw.pop("bit_depth")
    if kw.pop("scaling_list", False):
        sps_kw["scaling_list_enabled"] = True
    sbh = kw.pop("sbh", False)
    wp = kw.pop("wp", False)
    if "h" in kw:  # the clip's top rows
        frames = [(y[: kw["h"]], u[: kw["h"] // 2], v[: kw["h"] // 2])
                  for y, u, v in frames]
    cfg = ldp_cfg(npz, port=True, **kw)
    cfg.pps.sign_data_hiding = sbh
    cfg.pps.weighted_pred = wp
    for k, v in sps_kw.items():
        setattr(cfg.sps, k, v)
    if name in ADMITTED:
        enc, _ = encode_sequence(Reader(frames), cfg, max_frames=3,
                                 device="cpu")
        decoded = port_decode(enc.bitstream())
        assert len(decoded) == 3 and all(f.md5_ok for f in decoded), name
        return
    with pytest.raises(NotImplementedError, match="not yet ported") as e:
        encode_sequence(Reader(frames), cfg, max_frames=3, device="cpu")
    assert NAMED.get(name, "not yet ported") in str(e.value)


@pytest.mark.cuda
def test_cuda_scan_matches_cpu_and_launches_every_kernel(cuda_device, setup):
    npz, frames = setup
    cpu, _ = encode_sequence(Reader(frames), ldp_cfg(npz, port=True),
                             max_frames=9, device="cpu")
    reset_launches()
    gpu, _ = encode_sequence(Reader(frames), ldp_cfg(npz, port=True),
                             max_frames=9, device=cuda_device)
    ldp_kernels = ("sad_search", "nnfme_mlp", "mc_blk", "txq", "intra_bank",
                   "satd35_topk", "intra_txq", "tu_bits")
    assert all(LAUNCHES[k] > 0 for k in ldp_kernels), LAUNCHES
    assert gpu.bitstream() == cpu.bitstream()

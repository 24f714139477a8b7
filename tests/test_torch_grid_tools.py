"""The anchor LD-P cfg's four in-loop and quantiser tools on the grid step
(RDOQ, sign-bit hiding, deblocking, SAO) against tpuhevc's (JAX on the
CPU) at 128x64, seeded NN-FME weights, four references, TMVP granted:

- the grid RDOQ, the ideal levels and sign-bit hiding of `ops/grid_code`
  equal `inter_grid._PROBES` `rdoq_plane`, `ideal_plane` and `sbh_plane`
  level for level at T = 4, 8, 16 and 32, luma and chroma, on the warmed
  and on fed-back decision tables, at QP 32 (levels packed as int8) and
  QP 22 (int16); the bit estimate with sign-bit hiding equals the
  reference's `tu_bits(sbh=True)` within rtol 1e-5 (the port adds the
  table bits exactly, XLA in float32); the class coding with both tools
  equals `class_code`'s outputs (float costs within 1e-6 relative);
- deblocking and SAO on the inputs that the port's grid step gave them in
  an end-to-end encode: the deblocked planes equal `deblock_device` and
  what the host filter `ops/deblock.deblock_frame` gives in the port's
  decoder (the same input planes, the same output); the SAO
  statistics equal tpuhevc's host `collect_stats` (and are small enough
  that the reference's float32 sums are exact), the packed parameters and
  the filtered planes equal `sao_device`;
- end to end with the anchor's four tools on and QuadtreeTUMaxDepthInter
  3, at a flat QP (one GOP position: tpuhevc's scan with the four
  positions of the GOP QP offsets and the tools does not compile on the
  CPU in a test's time; the stage checks above cover the offsets' QPs
  and tables), on the clip of seed 3: the packed rows and the NAL
  units of the IDR and the whole first chunk equal tpuhevc's byte for
  byte (they precede the first picture with a 32x32 CU at RQT depth 2,
  picture 11, tpuhevc's fault, ROADMAP queue 3: from there tpuhevc's
  packed map, and so its deblocking, drop that depth); the port's stream
  of eighteen pictures, whose third chunk runs on fed-back decision
  tables, decodes with every hash OK and the encoder's recon in both
  decoders;
- on a GPU, the three kernels equal their plain versions at every call of
  a CUDA encode, and the CUDA stream equals the CPU stream.

Each JAX reference runs as one compiled XLA program per configuration.
"""

# jax is imported inside the tests that compare with it, so that the CUDA
# test of this file also loads where only the GPU stack is installed.
import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    DEBLOCK_KINDS, GOP_QP_OFFSETS, QP, Reader, clip_frames, cuda_device,
    deblock_inputs, fresh_grid, ldp_cfg, rng_planes, write_weights)
from tpuhevc_torch.codec import inter_grid as tig
from tpuhevc_torch.codec.decoder import decode_stream
from tpuhevc_torch.codec.encoder import encode_sequence
from tpuhevc_torch.device import on_device
from tpuhevc_torch.entropy.bitest import tu_bits_plain
from tpuhevc_torch.kernels import LAUNCHES, reset_launches
from tpuhevc_torch.ops.grid_code import (
    grid_code_batch, grid_code_batch_plain, grid_code_plain, ideal_tiles,
    rdoq_tiles, sbh_tiles)
from tpuhevc_torch.ops.grid_deblock import grid_deblock, grid_deblock_plain
from tpuhevc_torch.ops.grid_sao import (
    grid_sao_apply, grid_sao_apply_plain, grid_sao_plain, grid_sao_stats,
    grid_sao_stats_plain, sao_stats_plain)
from tpuhevc_torch.ops.intra import blocks, unblocks
from tpuhevc_torch.ops.transforms import forward_transform

W, H = 128, 64
NREF = 4
FRAMES = 18  # the IDR and three chunks of eight P pictures
CLIP_SEED = 3  # the first 32x32 CU at RQT depth 2: picture 11
JAX_FRAMES = 9  # tpuhevc encodes the IDR and the first chunk


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("nnfme")
    return {qp: write_weights(d / f"w{qp}.npz", qp) for qp in (QP, 22)}


def tools_cfg(npz, port, qp=QP, gop=True):
    """The anchor LD-P cfg's tools at 128x64: RDOQ, sign hiding,
    deblocking and SAO on, four references, QuadtreeTUMaxDepthInter 3,
    the GOP QP offsets (or, gop=False, a flat QP), TMVP requested."""
    cfg = ldp_cfg(npz[qp], W, H, port=port, num_ref_frames=NREF, qp=qp,
                  gop_qp_offsets=GOP_QP_OFFSETS if gop else ())
    cfg.sps.max_tu_depth_inter = 2
    cfg.rdoq = cfg.deblocking = True
    cfg.pps.sign_data_hiding = True
    cfg.sps.sao_enabled = True
    return cfg


_GRIDS: dict = {}


def jax_grid(npz, qp):
    """tpuhevc's grid of the tools configuration at `qp` (built, not
    compiled), its probes and the port's GridStep of the same, each
    build's probes kept here."""
    from tpuhevc.codec import inter_grid as jg
    from tpuhevc.models.nnfme import load_npz, select_qp_params

    if qp not in _GRIDS:
        params = select_qp_params(load_npz(npz[qp]), qp)
        nn = {min(max(qp + o, 0), 51): params for o in GOP_QP_OFFSETS}
        _, built = fresh_grid(jg.build_ldp_grid_scan,
                              tools_cfg(npz, False, qp), nn, 1)
        _GRIDS[qp] = (jg, built,
                      tig.GridStep(tools_cfg(npz, True, qp), nn, "cpu"))
    return _GRIDS[qp]


def tables(jg, probes, npz, qp, gpos, fb):
    """(JAX tabs, port _Tabs) of GOP position gpos, warmed or fed back."""
    jl = jg.grid_live_tables(tools_cfg(npz, False, qp), fb)
    tl = tig.grid_live_tables(tools_cfg(npz, True, qp), fb)
    q = min(max(qp + GOP_QP_OFFSETS[gpos], 0), 51)
    return (jg._tabs_with_live(probes["meta"]["tabs_by_qp"][q], jl[gpos]),
            tig._Tabs(tl[gpos], "cpu"), q)


def residual(seed, h, w, boost):
    o = rng_planes(seed, h, w)[0]
    rng = np.random.default_rng(seed)
    p = np.roll(o, (1, 2), (0, 1)) + rng.integers(-20, 21, (h, w))
    return ((o - p) * boost).astype(np.int32)


@pytest.mark.parametrize("qp", [QP, 22])
def test_rdoq_sbh_and_bits_match_jax(npz, qp):
    """Levels of rdoq_plane + sbh_plane(ideal_plane) and tu_bits(sbh=True)
    at every TU size, luma and chroma; QP 32 packs int8 levels (clipped to
    127), QP 22 int16; the warmed tables at GOP position 0 and, at QP 32,
    fed-back tables at position 3."""
    import jax
    import jax.numpy as jnp

    jg, P, step = jax_grid(npz, qp)
    assert step.lvl8 == (qp == QP)
    lim = 127 if step.lvl8 else 32767
    rng = np.random.default_rng(qp)
    fed = {q: rng.integers(0, 126, 256).astype(np.int32)
           for q in (qp + 1, qp + 3)}
    cases = [(0, {})] + ([(3, fed)] if qp == QP else [])
    for gpos, fb in cases:
        jt, tt, q0 = tables(jg, P, npz, qp, gpos, fb)
        for side in ("est_y", "est_c"):
            q = q0 if side == "est_y" else q0 - 1
            lam = np.float32(57.3 if side == "est_y" else 31.7)
            h, w = (H, W) if side == "est_y" else (H // 2, W)
            for lg in (2, 3, 4, 5):
                T = 1 << lg
                g = (h // T, w // T)
                res = residual(10 * gpos + lg, h, w, 4 if lg == 5 else 1)
                est_j, est_t = jt[side][lg], getattr(tt, side)[lg]

                def ref(r, lm, est_j=est_j, T=T, lg=lg, q=q):
                    c = P["fwd_tx"](r, T)
                    lv = P["rdoq_plane"](c, q, lg, lm, est_j)
                    sb = P["sbh_plane"](lv, P["ideal_plane"](c, q, lg))
                    tiles = sb.reshape(g[0], T, g[1], T).transpose(
                        0, 2, 1, 3).reshape(-1, T, T)
                    return c, lv, sb, est_j.tu_bits(jnp, tiles, sbh=True)

                jc, jl_, js, jb = (np.asarray(x) for x in jax.jit(ref)(
                    jnp.asarray(res), jnp.float32(lam)))
                c = forward_transform(blocks(t(res), T, *g)).long()
                np.testing.assert_array_equal(unblocks(c, *g).numpy(), jc)
                lv = rdoq_tiles(c, q, lg, torch.tensor(lam), est_t, lim)
                what = f"qp {q} {side} T {T} tables {gpos}"
                np.testing.assert_array_equal(unblocks(lv, *g).numpy(), jl_,
                                              "rdoq " + what)
                sb = sbh_tiles(lv, ideal_tiles(c, q, lg), lim)
                np.testing.assert_array_equal(unblocks(sb, *g).numpy(), js,
                                              "sbh " + what)
                assert (js != jl_).any() and (jl_ != 0).any(), what
                # the port sums the table bits exactly, XLA in float32:
                # within rtol 1e-5, atol 1e-3, as the intra decision's
                # bits (test_torch_intra.py)
                np.testing.assert_allclose(
                    tu_bits_plain(est_t, sb.int(), sbh=True).numpy(), jb,
                    rtol=1e-5, atol=1e-3, err_msg="tu_bits " + what)


def code_inputs(npz, dev):
    """grid_code's inputs for luma and chroma at QP 32 on dev: (side,
    orig, pred, lam (np.float32), {log2: estimator}, the cbf bits (2,)),
    the warmed tables; residuals and lambdas from a seeded numpy
    generator, half of each plane near its prediction (so that both coded
    and dropped TUs occur)."""
    tabs = tig._Tabs(tig.grid_live_tables(tools_cfg(npz, True), {})[0], dev)
    rng = np.random.default_rng(12)
    for side, cbf in (("est_y", tabs.cbf_y), ("est_c", tabs.cbf_c)):
        h, w = (H, W) if side == "est_y" else (H // 2, W)
        lam = np.float32(rng.uniform(20.0, 80.0))
        orig = rng.integers(0, 256, (h, w))
        amp = np.where(np.arange(w) < w // 2, 2, 40)[None]
        pred = np.clip(orig + rng.integers(-64, 65, (h, w)) * amp // 64, 0,
                       255)
        yield (side, t(orig.astype(np.int32)).to(dev),
               t(pred.astype(np.int32)).to(dev), lam, getattr(tabs, side),
               cbf)


def test_grid_code_plain_takes_device_form_scalars(npz):
    """grid_code_plain with lam a 0-dim float32 tensor and the cbf bits a
    (2,) tensor (the form GridStep passes and the kernel reads on the
    card) equals its float form (lam and cbf0, cbf1 as Python floats) bit
    for bit, RDOQ and sign hiding on, at T = 4, 8, 16 and 32, luma and
    chroma (`code_inputs`)."""
    for side, orig, pred, lam, ests, cbf in code_inputs(npz, "cpu"):
        coded = dropped = 0
        for lg in (2, 3, 4, 5):
            T = 1 << lg
            a = grid_code_plain(orig, pred, T, QP, torch.tensor(lam),
                                ests[lg], cbf, True, True, True)
            b = grid_code_plain(orig, pred, T, QP, float(lam), ests[lg],
                                (float(cbf[0]), float(cbf[1])), True, True,
                                True)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and torch.equal(x, y), (side, T)
            coded += int((a[4] > 0).sum())
            dropped += int((a[4] == 0).sum())
        assert coded > 0 and dropped > 0, (side, coded, dropped)


def test_class_code_with_rdoq_and_sbh_matches_jax(npz):
    """class_code with RDOQ and sign hiding on (the 32 class: the RQT to
    depth 2, chroma at 16 and 8) against the reference's, on the grid's
    own inputs (the intra-16 coding runs the same grid_code)."""
    import jax
    import jax.numpy as jnp

    from tpuhevc_torch.ops.grid_pred import grid_planes_plain

    jg, P, step = jax_grid(npz, QP)
    jt, tt, qp = tables(jg, P, npz, QP, 0, {})
    frames = clip_frames(W, H, 5)
    oy = frames[4][0].astype(np.int32)
    ouv = np.concatenate(frames[4][1:], 1).astype(np.int32)
    ry = np.stack([f[0] for f in frames[3::-1]]).astype(np.int32)
    ruv = np.stack([np.concatenate(f[1:], 1)
                    for f in frames[3::-1]]).astype(np.int32)
    py = grid_planes_plain(t(ry), True, step.PADL, step.HmL, step.WmL)
    halves = torch.cat([t(ruv)[:, :, : W // 2], t(ruv)[:, :, W // 2:]], 0)
    pc = grid_planes_plain(halves.contiguous(), False, step.PADC, step.HmC,
                           step.WmC)
    rng = np.random.default_rng(32)
    mv = rng.integers(-6, 7, (H // 32, W // 32, 2)).astype(np.int32)
    ref = rng.integers(0, NREF, (H // 32, W // 32)).astype(np.int32)
    lam = np.float32(40.0)
    c = step.class_code(qp, tt, torch.tensor(lam), t(oy), t(ouv), py, pc,
                        t(mv), t(ref), 32, H // 32, W // 32, tusplit=True)
    jc = jax.jit(lambda o, u, y, p, m, r, lm: P["class_code"](
        qp, jt, lm, o, u, y, p[:NREF], p[NREF:], m, r, 32, H // 32, W // 32,
        tusplit=True))(jnp.asarray(oy), jnp.asarray(ouv),
                       jnp.asarray(py.numpy()), jnp.asarray(pc.numpy()),
                       jnp.asarray(mv), jnp.asarray(ref), jnp.float32(lam))
    assert set(c) == set(jc)
    for k in jc:
        a, b = c[k].numpy(), np.asarray(jc[k])
        if k in ("d", "bits", "d0"):  # float32 costs
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, k)
    assert c["tsplit"].any() and (c["lvl"] != 0).any()


@pytest.fixture(scope="module")
def e2e(npz):
    """Eighteen frames through the port with the tools on (the third chunk
    on the decision tables fed back from the first one's slices), the IDR
    and the first chunk through tpuhevc (its scan's compile and run
    dominate this file's time; its RQT-depth fault comes later); the
    packed rows recorded where the host half parses them, the syntax the
    port assembled, the inputs and outputs of the port's deblocking and
    SAO (as the grid step called them), and the probes of tpuhevc's build
    ("P")."""
    from tpuhevc.codec import inter_grid as jg
    from tpuhevc.codec.encoder import encode_sequence as jax_encode

    frames = clip_frames(W, H, FRAMES, CLIP_SEED)
    rec = {"jax": [], "port": [], "fs": [], "deblock": [], "sao": []}

    def recorder(mod, key):
        real = mod.assemble_grid_frame

        def wrapped(cfg, buf, *a, **kw):
            rec[key].append(np.array(buf, np.uint8))
            out = real(cfg, buf, *a, **kw)
            if key == "port":
                rec["fs"].append(out[0])
            return out
        return wrapped

    def calls(name, real):
        def wrapped(*a):
            out = real(*a)
            rec[name].append((a, out))
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "assemble_grid_frame", recorder(jg, "jax"))
        mp.setattr(tig, "assemble_grid_frame", recorder(tig, "port"))
        mp.setattr(tig, "grid_deblock", calls("deblock", tig.grid_deblock))
        # SAO's three steps: the statistics, the decision, the apply
        for name in ("stats", "decide", "apply"):
            fn = "grid_sao_" + name
            rec[fn] = []
            mp.setattr(tig, fn, calls(fn, getattr(tig, fn)))
        (enc_j, _), probes = fresh_grid(
            jax_encode, Reader(frames), tools_cfg(npz, False, gop=False),
            max_frames=JAX_FRAMES)
        enc_t, recons = encode_sequence(
            Reader(frames), tools_cfg(npz, True, gop=False),
            max_frames=FRAMES, device="cpu")
    # each picture's SAO as one call: (oy, ouv, rec_y, rec_uv, lam, qp,
    # ctu) -> (rec_y, rec_uv, params)
    rec["sao"] = [((*st[:4], dc[2], dc[3], st[4]), (*ap_out, dc_out[1]))
                  for (st, _), (dc, dc_out), (_, ap_out) in zip(
                      rec["grid_sao_stats"], rec["grid_sao_decide"],
                      rec["grid_sao_apply"])]
    return dict(rec, cfg=tools_cfg(npz, True, gop=False), enc_j=enc_j,
                P=probes, enc_t=enc_t, recons=recons,
                fed_back=sorted(enc_t.ctx_feedback))


def test_deblock_matches_jax_and_host_filter(e2e):
    """Every P picture's deblocking (the composed maps with intra cells
    and the RQT depths) equals deblock_device, and equals the host filter
    `deblock_frame` as the port's decoder runs it on the parsed picture
    (the same input planes, the same output). So do synthetic adversarial
    inputs (`deblock_inputs`: flat 8x8 blocks with steps, noise, every
    cell intra, RQT depth 2 at CU 32, far motion at every edge) at QP 22,
    37 and 51, at the picture's size and as a 128-row stripe-shaped
    buffer (a picture of its own to the filter, its first row a border;
    against deblock_device of a build of that size)."""
    import jax
    import jax.numpy as jnp

    from tpuhevc.codec import inter_grid as jg
    from tpuhevc_torch.ops import deblock as host

    P = e2e["P"]
    dec = []
    real = host.deblock_frame

    def recorded(planes, fs, qp, intra, **kw):
        out = real(planes, fs, qp, intra, **kw)
        dec.append((planes, out, intra))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "deblock_frame", recorded)
        decode_stream(e2e["enc_t"].bitstream())
    assert [d[2] for d in dec] == [True] + [False] * (FRAMES - 1)
    seen = {"intra": False, "split": False, "filtered": False}
    # the pictures in coding order (the last chunk's padding after them)
    ref = {}  # one compiled program per QP
    for j, (args, (y, uv)) in enumerate(e2e["deblock"][: FRAMES - 1]):
        qp = args[-1]
        if qp not in ref:
            ref[qp] = jax.jit(lambda *a, qp=qp: P["deblock_device"](
                *a[:6], qp, a[6], a[7]))
        jy, juv = ref[qp](*(jnp.asarray(a.numpy()) for a in args[:-1]))
        a = grid_deblock_plain(*args)
        for x, z, k in ((a[0], jy, "y"), (a[1], juv, "uv"), (a[0], y, "y"),
                        (a[1], uv, "uv")):
            np.testing.assert_array_equal(x.numpy(), np.asarray(z),
                                          f"picture {j + 1} {k}")
        (hy, hu, hv), (oy, ou, ov), _ = dec[j + 1]
        for x, z, k in ((hy, args[0], "y in"), (oy, a[0], "y out"),
                        (np.concatenate([hu, hv], 1), args[1], "uv in"),
                        (np.concatenate([ou, ov], 1), a[1], "uv out")):
            np.testing.assert_array_equal(x, z.numpy(), f"host {j + 1} {k}")
        assert e2e["fs"][j].prefiltered  # the encoder does not deblock again
        seen["intra"] |= bool(args[6].any())
        seen["split"] |= bool(args[7].any())
        seen["filtered"] |= bool((a[0] != args[0]).any())
    assert all(seen.values()), seen
    # the synthetic cases: deblock_device of the e2e build, and of a build
    # 128 rows high (built, not compiled: only the filter is jitted)
    _, p128 = fresh_grid(jg.build_ldp_grid_scan, ldp_cfg(
        None, W, 128, fme_mode="none", deblocking=True, num_ref_frames=1,
        search_range=16, gop_qp_offsets=()), {QP: None}, 1)
    syn = {}
    for seed, kind in enumerate(DEBLOCK_KINDS):
        for h, probes in ((H, P), (128, p128)):
            args = deblock_inputs(kind, h, W, seed + h)
            for qp in (22, 37, 51):
                if (h, qp) not in syn:
                    syn[h, qp] = jax.jit(
                        lambda *a, qp=qp, pr=probes: pr["deblock_device"](
                            *a[:6], qp, a[6], a[7]))
                jy, juv = syn[h, qp](*(jnp.asarray(a.numpy()) for a in args))
                y, uv = grid_deblock_plain(*args, qp)
                for x, z, k in ((y, jy, "y"), (uv, juv, "uv")):
                    np.testing.assert_array_equal(
                        x.numpy(), np.asarray(z), f"{kind} {h} rows QP {qp} "
                        f"{k}")
                if qp == 51:  # every kind filters at the highest QP
                    assert (y != args[0]).any(), (kind, h)


def test_sao_matches_jax(e2e):
    """Every P picture's SAO: the statistics equal tpuhevc's host
    collect_stats (every |sum| below 2^24, so the reference's float32
    sums are exact); the packed parameters and the filtered planes equal
    sao_device's."""
    import jax
    import jax.numpy as jnp

    from tpuhevc.ops.sao import collect_stats

    P = e2e["P"]
    ctu = 1 << e2e["cfg"].sps.log2_ctu
    on = [False, False]
    ref = {}  # one compiled program per QP
    for j, (args, out) in enumerate(e2e["sao"][: FRAMES - 1]):
        oy, ouv, ry, ruv, lam, qp, c = args
        assert c == ctu
        wc = W // 2
        for o, r, cs in ((oy, ry, c), (ouv[:, :wc], ruv[:, :wc], c // 2),
                         (ouv[:, wc:], ruv[:, wc:], c // 2)):
            cnt, sm = sao_stats_plain(o, r, cs)
            st = collect_stats(o.numpy(), r.numpy(), cs)
            n = cnt.shape[0]
            np.testing.assert_array_equal(
                cnt.numpy(), np.concatenate([st["eo_count"].reshape(n, 16),
                                             st["bo_count"].reshape(n, 32)],
                                            1))
            np.testing.assert_array_equal(
                sm.numpy(), np.concatenate([st["eo_sum"].reshape(n, 16),
                                            st["bo_sum"].reshape(n, 32)], 1))
            assert int(sm.abs().max()) < 1 << 24
        if qp not in ref:
            ref[qp] = jax.jit(lambda *a, qp=qp: P["sao_device"](*a, qp))
        jy, juv, jp = ref[qp](*(jnp.asarray(a.numpy())
                                for a in (oy, ouv, ry, ruv, lam)))
        a = grid_sao_plain(*args)
        for x, z, k in zip(a, (jy, juv, jp), ("y", "uv", "params")):
            np.testing.assert_array_equal(x.numpy(), np.asarray(z),
                                          f"picture {j + 1} {k}")
        for x, z in zip(a, out):
            assert torch.equal(x, z)
        n = (H // ctu) * (W // ctu)
        p = a[2].numpy()
        on[0] |= bool((p[:n] != -1).any())
        on[1] |= bool((p[6 * n : 7 * n] != -1).any())
    assert all(on), on  # each component on in some picture


def test_e2e_tools_rows_and_stream_match_jax_and_decode(e2e):
    """The packed rows (SAO parameters included) and the stream's NAL
    units of the IDR and the first chunk equal tpuhevc's (the first
    picture that holds a 32x32 CU at RQT depth 2 comes after them); the
    port's stream decodes with every hash OK and the encoder's recon in
    both decoders."""
    from tpuhevc.codec.decoder import decode_stream as jax_decode

    cfg = e2e["cfg"]
    assert e2e["fed_back"] == [QP]  # the third chunk's tables
    trows, jrows = np.stack(e2e["port"]), np.stack(e2e["jax"])
    assert trows.shape == (FRAMES - 1, tig.frame_bytes(cfg))
    assert jrows.shape == (JAX_FRAMES - 1, tig.frame_bytes(cfg))
    deep = [j + 1 for j in range(len(trows))
            if ((tig._parse_frame_buf(cfg, trows[j])["tsplit_map"] == 2)
                & (tig._parse_frame_buf(cfg, trows[j])["log2_map"] == 5)
                ).any()]
    assert deep and deep[0] >= JAX_FRAMES, deep  # after the first chunk
    for j in range(JAX_FRAMES - 1):
        assert trows[j].tobytes() == jrows[j].tobytes(), f"picture {j + 1}"
    tn, jn = list(e2e["enc_t"].nals), list(e2e["enc_j"].nals)
    vcl = [i for i, n in enumerate(tn) if (n[0] >> 1) & 0x3F < 32]
    assert tn[: vcl[JAX_FRAMES]] == jn
    stream = e2e["enc_t"].bitstream()
    for dec in (decode_stream, jax_decode):
        frames = dec(stream)
        assert len(frames) == FRAMES and all(f.md5_ok for f in frames)
    for f, (ry, ru, rv) in zip(decode_stream(stream), e2e["recons"]):
        np.testing.assert_array_equal(f.y, ry[:H, :W])
        np.testing.assert_array_equal(f.u, ru[: H // 2, : W // 2])
        np.testing.assert_array_equal(f.v, rv[: H // 2, : W // 2])


# --- the kernels on the card -------------------------------------------------

@pytest.mark.cuda
def test_cuda_grid_tools_match_plain_and_cpu_stream(cuda_device, npz):
    """grid_code's kernel equals its plain version at T = 4, 8, 16 and 32
    with RDOQ and SBH on and off, lam and the cbf bits device tensors
    (`code_inputs`), each plane alone and all eight in one launch, and no
    launch syncs the stream (sync debug mode "error"); with a second card,
    a T = 32 RDOQ plane on cuda:1 after the launches on the first card;
    grid_code (RDOQ and SBH), grid_deblock and grid_sao equal their plain
    versions at every call of a CUDA encode with the tools on, and the
    CUDA stream equals the CPU stream."""
    jobs = []
    for side, orig, pred, lam, ests, cbf in code_inputs(npz, cuda_device):
        lam = torch.tensor(lam, device=cuda_device)
        jobs += [(orig, pred, 1 << lg, QP, lam, ests[lg], cbf)
                 for lg in (2, 3, 4, 5)]
    for tools in (True, False):
        for batch in [[j] for j in jobs] + [jobs]:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = grid_code_batch(batch, True, tools, tools)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            want = grid_code_batch_plain(batch, True, tools, tools)
            for o, w, j in zip(out, want, batch):
                assert all(torch.equal(x, y) for x, y in zip(o, w)), (
                    j[0].shape, j[2], tools, len(batch))
    if torch.cuda.device_count() > 1:
        # a T = 32 block with RDOQ needs more than 48 KB of shared memory,
        # an opt-in each card needs: a second card after the first
        d1 = torch.device("cuda", 1)
        with on_device(d1):
            for side, orig, pred, lam, ests, cbf in code_inputs(npz, d1):
                job = [(orig, pred, 32, QP, torch.tensor(lam, device=d1),
                        ests[5], cbf)]
                out = grid_code_batch(job, True, True, True)
                want = grid_code_batch_plain(job, True, True, True)
                assert all(torch.equal(x, y)
                           for x, y in zip(out[0], want[0])), (d1, side)
    frames = clip_frames(W, H, 9, CLIP_SEED)
    seen = {"grid_code": 0, "grid_deblock": 0, "grid_sao": 0}

    def checked(name, kern, plain):
        def wrapped(*a):
            out = kern(*a)
            want = plain(*a)
            if name == "grid_code":  # a launch of several planes
                out_t = [x for o in out for x in o]
                want = [x for o in want for x in o]
            else:
                out_t = out
            for x, y in zip(out_t, want):
                assert torch.equal(x, y), name
            seen[name] += 1
            return out
        return wrapped

    reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tig, "grid_code_batch",
                   checked("grid_code", grid_code_batch,
                           grid_code_batch_plain))
        mp.setattr(tig, "grid_deblock",
                   checked("grid_deblock", grid_deblock, grid_deblock_plain))
        # grid_sao's two launches: the statistics and the apply
        mp.setattr(tig, "grid_sao_stats",
                   checked("grid_sao", grid_sao_stats, grid_sao_stats_plain))
        mp.setattr(tig, "grid_sao_apply",
                   checked("grid_sao", grid_sao_apply, grid_sao_apply_plain))
        a, _ = encode_sequence(Reader(frames), tools_cfg(npz, True),
                               max_frames=9, device=cuda_device)
    assert all(LAUNCHES[k] > 0 for k in seen), LAUNCHES
    assert all(v > 0 for v in seen.values()), seen
    b, _ = encode_sequence(Reader(frames), tools_cfg(npz, True),
                           max_frames=9, device="cpu")
    assert a.bitstream() == b.bitstream()

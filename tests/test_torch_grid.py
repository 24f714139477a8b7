"""The LD-P grid step of tpuhevc_torch against tpuhevc's (JAX on the CPU)
at 128x64, where every CU class (8, 16, 32, 64) exists, seeded NN-FME
weights, QP 32, four references, SearchRange 64, TMVP granted:

- per stage, the port's plain versions equal the JAX stage closures of
  `inter_grid._PROBES` on the same inputs (anchor GOP QP offsets 3,2,3,1,
  QuadtreeTUMaxDepthInter 3): the coarse stack and picks, the prestage,
  the refine over five start grids with the 8-class quadrants, the luma
  and chroma phase planes, the 8x8 SATD and its DC-aware CU cost, the
  NN-FME offsets, the merge sweep of every class, the class coding with
  the inter RQT at every CU size and for rectangular PUs, and the CU cost;
  integers bit for bit, float costs within 1e-6 relative (all equal here);
- the intra-16 candidate's seven predictions equal tpuhevc's HM-exact
  numpy intra prediction, and its decision is the first SATD minimum;
- eighteen pictures end to end through both encoders (flat QP,
  QuadtreeTUMaxDepthInter 3; three chunks of eight P pictures, the third
  on decision tables fed back from the first one's written slices): the
  packed rows equal tpuhevc's byte for byte, and so do the streams, up to
  the first 32x32 CU that takes the second RQT level; there tpuhevc's
  grid clears that depth in its packed map (the `&` of the int8 depth map
  with a boolean mask keeps bit 0 only) while the port keeps it, so the
  port's stream decodes with every hash OK in both decoders and
  tpuhevc's does not (ROADMAP, queue 3);
- the port takes the grid where `supports` holds and the non-grid scan
  elsewhere; the native walk's entry points are required;
- on a GPU, G1-G6 equal their plain versions, and the CUDA stream equals
  the CPU stream.

The JAX grid scan is compiled once per module, by the end-to-end encode;
each stage check compiles the closures it calls.
"""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import ctypes

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    GOP_QP_OFFSETS, QP, Reader, clip_frames, cuda_device, fresh_grid,
    ldp_cfg, rng_planes, write_weights)
from tpuhevc_torch.codec import inter_grid as tig
from tpuhevc_torch.codec.decoder import decode_stream
from tpuhevc_torch.codec.encoder import (LdpScanDriver, _takes_scan,
                                         check_slice)
from tpuhevc_torch.codec.encoder import encode_sequence
from tpuhevc_torch.codec.params import p_frame_lambda
from tpuhevc_torch.entropy import native
from tpuhevc_torch.kernels import LAUNCHES, reset_launches
from tpuhevc_torch.models.nnfme import (
    NNFME, height_category, nn_refine, width_category)
from tpuhevc_torch.ops.grid_code import grid_code_batch, grid_code_plain, up
from tpuhevc_torch.ops.grid_intra import (
    IMODES, cell_refs, grid_intra16, grid_intra16_plain, intra_preds)
from tpuhevc_torch.ops.grid_me import (
    grid_coarse, grid_coarse_plain, grid_prestage, grid_prestage_plain,
    grid_refine, grid_refine_plain, tile_sum)
from tpuhevc_torch.ops.grid_pred import (
    SatdField, grid_mc, grid_mc_plain, grid_planes, grid_planes_plain,
    grid_satd_cost, grid_satd_cost_plain, grid_satd_plain, group_sum, satd8,
    satd_z)

W, H = 128, 64
NREF = 4


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def j2n(x):
    return np.asarray(x)


def close(a, b, what):
    """Float32 costs: equal within 1e-6 relative."""
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-6,
                               atol=1e-6, err_msg=what)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_weights(tmp_path_factory.mktemp("nnfme") / "w.npz")


def stage_cfg(npz, port):
    cfg = ldp_cfg(npz, W, H, port=port, num_ref_frames=NREF)
    cfg.sps.max_tu_depth_inter = 2  # QuadtreeTUMaxDepthInter 3
    cfg.sps.temporal_mvp_enabled = True
    return cfg


@pytest.fixture(scope="module")
def base(npz):
    """The port's GridStep of the stage configuration and one picture's
    inputs: frame 4 against the four frames before it (originals standing
    in for their recons), GOP position 0 (QP 35)."""
    from tpuhevc_torch.models.nnfme import load_npz, select_qp_params

    tcfg = stage_cfg(npz, True)
    params = select_qp_params(load_npz(npz), QP)
    qps = sorted({min(max(QP + o, 0), 51) for o in GOP_QP_OFFSETS})
    nn_by_qp = {qp: params for qp in qps}
    step = tig.GridStep(tcfg, nn_by_qp, "cpu")
    frames = clip_frames(W, H, 5)
    oy = frames[4][0].astype(np.int32)
    ouv = np.concatenate(frames[4][1:], 1).astype(np.int32)
    ry = np.stack([f[0] for f in frames[3::-1]]).astype(np.int32)
    ruv = np.stack([np.concatenate(f[1:], 1)
                    for f in frames[3::-1]]).astype(np.int32)
    gpos = 0
    qp = step.qps[gpos]
    lam_py = p_frame_lambda(tcfg, gpos, qp)
    tlive = tig.grid_live_tables(tcfg, {})
    return dict(
        step=step, cfg=tcfg, qp=qp, gpos=gpos, nn_by_qp=nn_by_qp,
        lam=np.float32(lam_py), lam_me_f=np.float32(np.sqrt(lam_py)),
        lam_me=int(round(np.sqrt(lam_py) * 256)), oy=oy, ouv=ouv, ry=ry,
        ruv=ruv, tabs=tig._Tabs(tlive[gpos], "cpu"), params=params)


# the stage closures compiled per call; the search closures (coarse stack,
# picks, refine) run faster op by op
JITTED = ("luma_planes_all", "chroma_planes_all", "pred_satd_z",
          "satd8_plane", "nn_refine", "cand_sweep", "class_code", "cu_cost")


def jitted(fn):
    """A JAX stage closure that runs each call as one compiled XLA program,
    as the grid scan runs it: jax arrays are traced, every other argument
    is a constant of the call."""
    import jax

    def call(*args, **kw):
        pos = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]
        keys = [k for k, v in kw.items() if isinstance(v, jax.Array)]

        def run(xs, ys):
            a, k = list(args), dict(kw)
            for i, x in zip(pos, xs):
                a[i] = x
            k.update(zip(keys, ys))
            return fn(*a, **k)
        return jax.jit(run)([args[i] for i in pos], [kw[k] for k in keys])
    return call


@pytest.fixture(scope="module")
def st(base, npz):
    """`base` plus the stage closures of one JAX grid build of the same
    configuration (built, not compiled: each check compiles the closures
    it calls) and its decision tables."""
    import jax.numpy as jnp

    from tpuhevc.codec import inter_grid as jg

    jcfg = stage_cfg(npz, False)
    _, built = fresh_grid(jg.build_ldp_grid_scan, jcfg, base["nn_by_qp"], 1)
    probes = {k: jitted(v) if k in JITTED else v for k, v in built.items()}
    qp = base["qp"]
    jlive = jg.grid_live_tables(jcfg, {})
    jtabs = jg._tabs_with_live(probes["meta"]["tabs_by_qp"][qp],
                               jlive[base["gpos"]])
    return dict(base, jnp=jnp, jg=jg, P=probes, jtabs=jtabs)


def check_live_tables(st, npz):
    """The decision tables, from the warmed init states and from a fed-back
    context snapshot, equal tpuhevc's per GOP position."""
    jg = st["jg"]
    rng = np.random.default_rng(7)
    states = {q: rng.integers(0, 126, 256).astype(np.int32)
              for q in (QP + 2, QP + 3)}
    for fb in ({}, states):
        jl = jg.grid_live_tables(stage_cfg(npz, False), fb)
        tl = tig.grid_live_tables(st["cfg"], fb)
        assert len(jl) == len(tl) == len(GOP_QP_OFFSETS)
        for a, b in zip(jl, tl):
            for k in tig._LIVE_SCALARS + tig._LIVE_VECTORS + (
                    "mvd_lut", "ref_bits"):
                np.testing.assert_array_equal(np.asarray(a[k], np.float32),
                                              np.asarray(b[k], np.float32))
            for lg in (3, 4, 5):
                np.testing.assert_array_equal(a["tsplit"][lg],
                                              b["tsplit"][lg])
            for side in ("est_y", "est_c"):
                for lg in (2, 3, 4, 5):
                    for f, v in a[side][lg].items():
                        np.testing.assert_array_equal(
                            v, getattr(b[side][lg], f), err_msg=f)


def check_coarse_pick_and_prestage(st):
    jnp, P, step = st["jnp"], st["P"], st["step"]
    oy, ry0 = st["oy"], st["ry"][0]
    qp, lam_me = st["qp"], st["lam_me"]
    nc, R2 = step.nc, step.R2
    oy2 = tile_sum(t(oy), 2).int()
    ry2p = step._pad_edge(tile_sum(t(ry0), 2).int(), R2)
    sad, sm = grid_coarse_plain(oy2, ry2p, nc, 8, 1, True)
    jsad, jsm = P["coarse_stack"](jnp.asarray(oy2.numpy(), jnp.int16),
                                  jnp.asarray(ry2p.numpy(), jnp.int16))
    np.testing.assert_array_equal(sad.numpy(), j2n(jsad))
    np.testing.assert_array_equal(sm.numpy(), j2n(jsm))
    for nbh, nbw, f in ((H // 16, W // 16, 1), (H // 32, W // 32, 2)):
        cx, cy = step.pick_coarse(sad, sm, qp, lam_me, nbh, nbw, f)
        jx, jy = P["pick_coarse"](jsad, jsm, qp, lam_me, nbh, nbw, f)
        np.testing.assert_array_equal(cx.numpy(), j2n(jx))
        np.testing.assert_array_equal(cy.numpy(), j2n(jy))
    # the +-64 prestage: the reference's ps_row scan, re-expressed in jnp
    P4 = step.sr_full // 4
    n4 = 2 * P4 + 1
    oy4 = tile_sum(t(oy), 4).int()
    ry4p = step._pad_edge(tile_sum(t(ry0), 4).int(), P4)
    barg = grid_prestage_plain(oy4, ry4p, n4, 4, 2, step.pre_bits,
                               lam_me).reshape(-1)
    o4, r4 = jnp.asarray(oy4.numpy()), jnp.asarray(ry4p.numpy())
    best = np.full(o4.shape[0] // 4 * (o4.shape[1] // 4), 1 << 30)
    jarg = np.zeros_like(best)
    for dy in range(n4):
        mvyq = 16.0 * jnp.abs(dy - P4).astype(jnp.float32)
        for dx in range(n4):
            d = r4[dy : dy + o4.shape[0], dx : dx + o4.shape[1]] - o4
            c = np.asarray(d.__abs__().reshape(o4.shape[0] // 4, 4, -1, 4)
                           .sum((1, 3)) << 2).reshape(-1)
            bb = int((2 * jnp.ceil(jnp.log2(2.0 * mvyq + 1.0))
                      + 2 * np.ceil(np.log2(2.0 * abs(16 * (dx - P4)) + 1.0))
                      + 2).astype(jnp.int32))
            c = c + ((bb * lam_me) >> 8)
            take = c < best
            best = np.where(take, c, best)
            jarg = np.where(take, dy * n4 + dx, jarg)
    np.testing.assert_array_equal(barg.numpy(), jarg)


def refine_case(st, S, quads, ref_idx):
    """Port and JAX refine of one class: ref 0 with the five start grids
    (coarse, zero, global, temporal seed, prestage), ref > 0 the coarse
    grid only."""
    jnp, P, step = st["jnp"], st["P"], st["step"]
    rng = np.random.default_rng(S + ref_idx)
    nbh, nbw = H // S, W // S
    cx = rng.integers(-8, 9, (nbh, nbw)).astype(np.int32)
    cy = rng.integers(-8, 9, (nbh, nbw)).astype(np.int32)
    g = (3, -2)
    ts = (rng.integers(-20, 21, (nbh, nbw)).astype(np.int32),
          rng.integers(-20, 21, (nbh, nbw)).astype(np.int32))
    pre = (rng.integers(-15, 16, (nbh, nbw)).astype(np.int32) * 4,
           rng.integers(-15, 16, (nbh, nbw)).astype(np.int32) * 4)
    ry = st["ry"][ref_idx]
    if ref_idx == 0:
        starts = [(t(cx) * 2, t(cy) * 2), (t(cx) * 0, t(cy) * 0),
                  (torch.full_like(t(cx), g[0] * 2),
                   torch.full_like(t(cx), g[1] * 2)),
                  (t(ts[0]), t(ts[1])), (t(pre[0]), t(pre[1]))]
        jout = P["refine"](jnp.asarray(ry), jnp.asarray(st["oy"]),
                           jnp.asarray(cx), jnp.asarray(cy), S, nbh, nbw,
                           st["qp"], st["lam_me"], with_zero=True,
                           global_c=g, extra_c=tuple(map(jnp.asarray, ts)),
                           extra_c2=tuple(map(jnp.asarray, pre)),
                           want_quads=quads)
    else:
        starts = [(t(cx) * 2, t(cy) * 2)]
        jout = P["refine"](jnp.asarray(ry), jnp.asarray(st["oy"]),
                           jnp.asarray(cx), jnp.asarray(cy), S, nbh, nbw,
                           st["qp"], st["lam_me"], with_zero=False,
                           want_quads=quads)
    main, quad = step.refine(t(ry), t(st["oy"]), starts, S, nbh, nbw,
                             st["qp"], st["lam_me"], quads=quads)
    for a, b in zip(main, jout[:3]):
        np.testing.assert_array_equal(a.numpy(), j2n(b))
    if quads:
        for a, b in zip(quad, jout[3]):
            np.testing.assert_array_equal(a.numpy(), j2n(b))
    return starts, main, quad


REFINE_CASES = [(16, True, 0), (32, False, 0), (16, True, 2), (32, False, 3)]


def check_planes(st):
    jnp, P, step = st["jnp"], st["P"], st["step"]
    pl = grid_planes_plain(t(st["ry"]), True, step.PADL, step.HmL, step.WmL)
    np.testing.assert_array_equal(
        pl.numpy(), j2n(P["luma_planes_all"](jnp.asarray(st["ry"]))))
    Wc = W // 2
    halves = torch.cat([t(st["ruv"])[:, :, :Wc], t(st["ruv"])[:, :, Wc:]], 0)
    pc = grid_planes_plain(halves.contiguous(), False, step.PADC, step.HmC,
                           step.WmC)
    ju, jv = P["chroma_planes_all"](jnp.asarray(st["ruv"]))
    np.testing.assert_array_equal(pc[:NREF].numpy(), j2n(ju))
    np.testing.assert_array_equal(pc[NREF:].numpy(), j2n(jv))


@pytest.fixture(scope="module")
def planes(base):
    st = base
    step = st["step"]
    py = grid_planes_plain(t(st["ry"]), True, step.PADL, step.HmL, step.WmL)
    Wc = W // 2
    halves = torch.cat([t(st["ruv"])[:, :, :Wc], t(st["ruv"])[:, :, Wc:]], 0)
    pc = grid_planes_plain(halves.contiguous(), False, step.PADC, step.HmC,
                           step.WmC)
    return py, pc


def fields(S, seed, spread=40):
    """A per-CU (mv quarter-pel, ref) field of class S."""
    rng = np.random.default_rng(seed)
    nbh, nbw = H // S, W // S
    mv = rng.integers(-spread, spread + 1, (nbh, nbw, 2)).astype(np.int32)
    ref = rng.integers(0, NREF, (nbh, nbw)).astype(np.int32)
    return mv, ref


def check_satd(st, planes, S):
    jnp, P, step = st["jnp"], st["P"], st["step"]
    py, _ = planes
    jpy = jnp.asarray(py.numpy())
    mv, ref = fields(S, S)
    a = step.pred_satd_z(py, t(st["oy"]), t(mv), t(ref), S, st["qp"],
                         torch.tensor(st["lam_me_f"]))
    b = P["pred_satd_z"](jpy, jnp.asarray(st["oy"]), jnp.asarray(mv),
                         jnp.asarray(ref), S, H, W, st["qp"],
                         jnp.float32(st["lam_me_f"]))
    close(a.numpy(), j2n(b), f"pred_satd_z S={S}")
    # the cost entry's plain version, two fields in one call (mode z) and
    # the half-size cells' pairs (mode plain), against the composition
    oy, lam = t(st["oy"]), torch.tensor(np.float32(st["lam_me_f"]))
    fl = step.cu_field(t(mv), t(ref), S, st["qp"])
    f = S // 8
    _, m8, s8 = grid_satd_plain(
        py, up(t(mv).permute(2, 0, 1), f).permute(1, 2, 0)[None].contiguous(),
        up(t(ref), f)[None].contiguous(), 8, step.LOOK, oy, want_pred=False)
    want = satd_z(m8[0], s8[0], S, H // S, W // S, fl.dc, lam)
    for got in grid_satd_cost_plain(py, oy, [fl, fl], step.LOOK, "z", lam):
        assert torch.equal(got, want), S
    C = max(S // 2, 8)
    hmv, href = (t(x) for x in fields(C, C + 1))
    sat = grid_satd_cost_plain(py, oy, [SatdField(
        hmv, href, C, H // C, W // C, k) for k in (1, 4)], step.LOOK, "plain")
    for k, first in ((0, hmv[:, 0::2].repeat_interleave(2, 1)),
                     (1, hmv[1::2].repeat_interleave(2, 0))):
        rf = (href[:, 0::2].repeat_interleave(2, 1) if k == 0
              else href[1::2].repeat_interleave(2, 0))
        g = C // 8
        _, m8h, _ = grid_satd_plain(
            py, up(first.permute(2, 0, 1), g).permute(1, 2, 0)[None]
            .contiguous(), up(rf, g)[None].contiguous(), 8, step.LOOK, oy,
            want_pred=False)
        assert torch.equal(sat[k], group_sum(m8h[0], g).float()), (S, k)
    res = rng_planes(S, H, W)[0] - 128
    np.testing.assert_array_equal(satd8(t(res)).numpy(),
                                  j2n(P["satd8_plane"](jnp.asarray(res))))


def check_nn_refine(st, S):
    jnp, P = st["jnp"], st["P"]
    rng = np.random.default_rng(S)
    nb = (H // S) * (W // S)
    sad9 = rng.integers(0, 4000, (nb, 9)).astype(np.int32)
    _, _, off = nn_refine(NNFME.from_numpy(st["params"], "cpu"), t(sad9),
                          height_category(S), width_category(S))
    np.testing.assert_array_equal(
        off.numpy(), j2n(P["nn_refine"](st["qp"], jnp.asarray(sad9), S, nb)))


def check_merge_sweep(st, planes):
    """cand_sweep_all over the 16, 8 and 32 classes equals the reference's
    per-class sweep of each (the fused schedule's extra passes reach no
    block of the smaller grids)."""
    jnp, P, step = st["jnp"], st["P"], st["step"]
    py, _ = planes
    specs = []
    for S in (16, 8, 32):
        mv, ref = fields(S, 100 + S, 24)
        specs.append((S, H // S, W // S, t(mv), t(ref)))
    outs = step.cand_sweep_all(st["tabs"], st["qp"],
                               torch.tensor(st["lam_me_f"]), t(st["oy"]), py,
                               specs)
    jpy = jnp.asarray(py.numpy())
    for (S, nbh, nbw, mv, ref), out in zip(specs, outs):
        jo = P["cand_sweep"](st["jtabs"], st["qp"],
                             jnp.float32(st["lam_me_f"]),
                             jnp.asarray(st["oy"]), jpy,
                             jnp.asarray(mv.numpy()),
                             jnp.asarray(ref.numpy()), S, nbh, nbw)
        for k, (a, b) in enumerate(zip(out, jo)):
            if k == 2 or k == 4:
                close(a.numpy(), j2n(b), f"sweep S={S} field {k}")
            else:
                np.testing.assert_array_equal(a.numpy(), j2n(b),
                                              f"sweep S={S} field {k}")


CLASS_CASES = [(8, False, False), (16, True, False), (32, True, False),
               (64, True, False), (16, False, True), (32, False, True)]


def check_class_code_and_cu_cost(st, planes, S, tusplit, rect):
    """class_code with the RQT (depth 2 at 32) or with per-8-cell
    rectangular-PU fields, then cu_cost, against the reference's."""
    jnp, P, step = st["jnp"], st["P"], st["step"]
    py, pc = planes
    mv, ref = fields(S, 200 + S)
    nbh, nbw = H // S, W // S
    kw, jkw = {}, {}
    if rect:
        f = S // 16
        mvc, refc = fields(S // 2, 300 + S)
        mv_cells = up(t(mvc).permute(2, 0, 1), f).permute(1, 2, 0)
        ref_cells = up(t(refc), f)
        kw = dict(mv_cells=mv_cells, ref_cells=ref_cells)
        jkw = dict(mv_cells=jnp.asarray(mv_cells.numpy()),
                   ref_cells=jnp.asarray(ref_cells.numpy()))
    c = step.class_code(st["qp"], st["tabs"], torch.tensor(st["lam"]),
                        t(st["oy"]), t(st["ouv"]), py, pc,
                        None if rect else t(mv), None if rect else t(ref),
                        S, nbh, nbw, tusplit=tusplit, **kw)
    jpc = jnp.asarray(pc.numpy())
    jc = P["class_code"](st["qp"], st["jtabs"], jnp.float32(st["lam"]),
                         jnp.asarray(st["oy"]), jnp.asarray(st["ouv"]),
                         jnp.asarray(py.numpy()), jpc[:NREF], jpc[NREF:],
                         None if rect else jnp.asarray(mv),
                         None if rect else jnp.asarray(ref), S, nbh, nbw,
                         tusplit=tusplit, **jkw)
    assert set(c) == set(jc)
    for k in jc:
        a, b = c[k].numpy(), j2n(jc[k])
        if k in ("d", "bits", "d0"):
            close(a, b, f"class_code S={S} {k}")
        else:
            np.testing.assert_array_equal(a, b, f"class_code S={S} {k}")
    rng = np.random.default_rng(S)
    mode_b = rng.uniform(1, 20, (nbh, nbw)).astype(np.float32)
    merged = rng.integers(0, 2, (nbh, nbw)).astype(bool)
    midx = rng.uniform(0, 3, (nbh, nbw)).astype(np.float32)
    a = step.cu_cost(st["tabs"], torch.tensor(st["lam"]), c, t(mode_b),
                     t(merged), t(midx), S)
    b = P["cu_cost"](st["jtabs"], jnp.float32(st["lam"]), jc,
                     jnp.asarray(mode_b), jnp.asarray(merged),
                     jnp.asarray(midx), S)
    for x, y in zip(a, b):
        close(x.numpy(), j2n(y), f"cu_cost S={S}")


def test_stage_tables_search_and_planes_match_jax(st, npz):
    """The live decision tables; the coarse stack, its picks and the
    prestage; the refine of the 16 (with the 8-class quadrants) and 32
    classes at reference 0 (five start grids) and at later references;
    the luma and chroma phase planes."""
    check_live_tables(st, npz)
    check_coarse_pick_and_prestage(st)
    for case in REFINE_CASES:
        refine_case(st, *case)
    check_planes(st)


def test_stage_costs_and_sweep_match_jax(st, planes):
    """The DC-aware SATD cost per CU class and the 8x8 SATD plane, the
    NN-FME offsets per class, and the merge sweep of every class."""
    for S in (8, 16, 32, 64):
        check_satd(st, planes, S)
    for S in (8, 16, 32):
        check_nn_refine(st, S)
    check_merge_sweep(st, planes)


def test_stage_class_code_and_cu_cost_match_jax(st, planes):
    """class_code at every CU size (the RQT to depth 2 at 32) and for
    rectangular-PU fields, and cu_cost on each."""
    for case in CLASS_CASES:
        check_class_code_and_cu_cost(st, planes, *case)


def test_intra16_predictions_match_hm(st):
    """The seven IMODES predictions of every 16-cell (smoothing and edge
    filters by the spec's rules) and the 8x8 DM chroma ones equal
    tpuhevc's HM-exact numpy intra prediction on the same references; the
    decision is the first minimum of the 8x8 Hadamard SATD."""
    from tpuhevc.ops.intra import predict_block_np

    step = st["step"]
    oy, ouv = t(st["oy"]), t(st["ouv"])
    nh, nw = H // 16, W // 16
    tt, ll = cell_refs(oy, 16, 0, nh, nw, step.avtr_flat, step.avbl_flat)
    preds = intra_preds(tt, ll, 16, True)
    for n in range(nh * nw):
        for i, m in enumerate(IMODES):
            ref = predict_block_np(tt[n].numpy(), ll[n].numpy(), m, 16, True)
            np.testing.assert_array_equal(preds[n, i].numpy(), ref)
    modes, pred_y, pred_uv = grid_intra16_plain(
        oy, ouv, step.avtr_flat, step.avbl_flat, nh, nw, cur=oy)
    cur = oy.reshape(nh, 16, nw, 16).permute(0, 2, 1, 3).reshape(-1, 16, 16)
    sat = np.stack([satd8(cur - preds[:, i]).sum(dim=(1, 2)).numpy()
                    for i in range(len(IMODES))], 1)
    np.testing.assert_array_equal(modes.numpy(), np.argmin(sat, 1))
    for ox in (0, W // 2):
        tc, lc = cell_refs(ouv, 8, ox, nh, nw, step.avtr_flat,
                           step.avbl_flat)
        pc = intra_preds(tc, lc, 8, False)
        for n in range(nh * nw):
            for i, m in enumerate(IMODES):
                np.testing.assert_array_equal(
                    pc[n, i].numpy(),
                    predict_block_np(tc[n].numpy(), lc[n].numpy(), m, 8,
                                     False))
        got = pred_uv[:, ox : ox + W // 2].reshape(nh, 8, nw, 8).permute(
            0, 2, 1, 3).reshape(-1, 8, 8)
        np.testing.assert_array_equal(
            got.numpy(), pc[torch.arange(nh * nw), modes.long()].numpy())


# --- the slice end to end ---------------------------------------------------

E2E_FRAMES = 18  # the IDR and three chunks of eight P pictures


def e2e_cfg(npz, port):
    """The end-to-end configuration: flat QP (one GOP position), four
    references, SearchRange 64, QuadtreeTUMaxDepthInter 3, TMVP requested
    (granted by both encoders on this path)."""
    cfg = ldp_cfg(npz, W, H, port=port, num_ref_frames=NREF,
                  gop_qp_offsets=())
    cfg.sps.max_tu_depth_inter = 2
    return cfg


@pytest.fixture(scope="module")
def e2e(npz):
    """Eighteen frames through both encoders, the packed rows recorded
    where the host half parses them. The first two chunks run on the
    warmed tables, the third on the tables of the first chunk's written
    slices (`LdpScanDriver` serialises a chunk while the next computes)."""
    from tpuhevc.codec import inter_grid as jg
    from tpuhevc.codec.encoder import encode_sequence as jax_encode

    frames = clip_frames(W, H, E2E_FRAMES)
    rows = {"jax": [], "port": []}

    def recorder(mod, key):
        real = mod.assemble_grid_frame

        def rec(cfg, buf, *a, **kw):
            rows[key].append(np.array(buf, np.uint8))
            return real(cfg, buf, *a, **kw)
        return rec

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "assemble_grid_frame", recorder(jg, "jax"))
        mp.setattr(tig, "assemble_grid_frame", recorder(tig, "port"))
        (enc_j, _), _ = fresh_grid(jax_encode, Reader(frames),
                                   e2e_cfg(npz, False), max_frames=E2E_FRAMES)
        tcfg = e2e_cfg(npz, True)
        enc_t, recons = encode_sequence(Reader(frames), tcfg,
                                        max_frames=E2E_FRAMES, device="cpu")
    return dict(cfg=tcfg, jrows=np.stack(rows["jax"]),
                trows=np.stack(rows["port"]), jnals=list(enc_j.nals),
                tnals=list(enc_t.nals), jstream=enc_j.bitstream(),
                tstream=enc_t.bitstream(), recons=recons,
                fed_back=sorted(enc_t.ctx_feedback))


def test_e2e_rows_and_stream_match_jax_and_decode(e2e):
    """Every packed row equals tpuhevc's byte for byte but for the RQT
    depth of 32x32 CUs that take its second level (the port writes 2,
    tpuhevc 0); the streams' NAL units are equal up to the first picture
    that holds such a CU; the port's stream decodes with every hash OK and
    the encoder's recon in both decoders, tpuhevc's fails from there."""
    from tpuhevc.codec.decoder import decode_stream as jax_decode

    cfg, jrows, trows = e2e["cfg"], e2e["jrows"], e2e["trows"]
    assert e2e["fed_back"] == [QP]  # the third chunk's tables
    assert trows.dtype == np.uint8 and trows.shape == jrows.shape == (
        E2E_FRAMES - 1, tig.frame_bytes(cfg))
    deep = []  # P pictures (POC) with a 32x32 CU at RQT depth 2
    for j in range(len(jrows)):
        a = tig._parse_frame_buf(cfg, trows[j])
        b = tig._parse_frame_buf(cfg, jrows[j])
        fault = (a["tsplit_map"] == 2) & (a["log2_map"] == 5)
        for k in a:
            if k != "tsplit_map":
                np.testing.assert_array_equal(a[k], b[k], f"{k} {j + 1}")
        np.testing.assert_array_equal(
            a["tsplit_map"], np.where(fault, 2, b["tsplit_map"]))
        assert (b["tsplit_map"][fault] == 0).all()
        if fault.any():
            deep.append(j + 1)
        else:
            assert trows[j].tobytes() == jrows[j].tobytes(), f"frame {j + 1}"
    # the first chunk is byte-identical; the fault is met later
    assert deep and deep[0] > 8, deep
    tn, jn = e2e["tnals"], e2e["jnals"]
    first = next(i for i, (x, y) in enumerate(zip(tn, jn)) if x != y)
    vcl = [i for i, n in enumerate(tn) if (n[0] >> 1) & 0x3F < 32]
    assert first == vcl[deep[0]], (first, deep)  # that picture's slice
    for dec in (decode_stream, jax_decode):
        frames = dec(e2e["tstream"])
        assert len(frames) == E2E_FRAMES and all(f.md5_ok for f in frames)
    for f, (ry, ru, rv) in zip(decode_stream(e2e["tstream"]), e2e["recons"]):
        np.testing.assert_array_equal(f.y, ry[:H, :W])
        np.testing.assert_array_equal(f.u, ru[: H // 2, : W // 2])
        np.testing.assert_array_equal(f.v, rv[: H // 2, : W // 2])
    ok = [f.md5_ok for f in decode_stream(e2e["jstream"])]
    assert ok == [poc < deep[0] for poc in range(E2E_FRAMES)], ok


CUT = [("fme_mode", "dctif"), ("weighted_pred", True)]
TOOLS = [("rdoq", True), ("deblocking", True), ("sign_data_hiding", True),
         ("sao_enabled", True)]


def _set(cfg, field, value):
    obj = (cfg.pps if field in ("sign_data_hiding", "weighted_pred")
           else cfg.sps if field == "sao_enabled" else cfg)
    setattr(obj, field, value)
    return cfg


def test_grid_selection_cut_and_native_walk(npz, monkeypatch):
    """The grid where the coded size is whole 16x16 blocks, the non-grid
    scan elsewhere (112x72); DCT-IF, weighted prediction, RDOQ, sign
    hiding, deblocking and SAO admitted on the grid (128x64); at 112x72
    DCT-IF and the four tools admitted off the scan (the per-picture P
    path with the host tool stage) and weighted prediction refused; a
    native library without the decision walks fails to bind (no silent
    slower path)."""
    assert tig.supports(e2e_cfg(npz, True))
    assert not tig.supports(ldp_cfg(npz, port=True))

    class Enc:
        ctx_feedback: dict = {}

        def _nn_for_qp(self, qp):
            return None

    for cfg, grid in ((e2e_cfg(npz, True), True),
                      (ldp_cfg(npz, port=True), False)):
        drv = LdpScanDriver(Enc(), cfg, [None, None], None, "cpu")
        assert drv.grid == grid and drv.R == (NREF if grid else 1)
    for field, value in CUT + TOOLS:
        check_slice(_set(e2e_cfg(npz, True), field, value))
        off_grid = _set(ldp_cfg(npz, port=True), field, value)
        if field == "weighted_pred":
            with pytest.raises(NotImplementedError, match="not yet ported"):
                check_slice(off_grid)
        else:  # the per-picture loop, not the scan
            check_slice(off_grid)
            assert not _takes_scan(off_grid)
    real = ctypes.CDLL(native._lib_path())

    class NoWalk:
        def __init__(self, path):
            self._lib = real

        def __getattr__(self, name):
            if name.startswith("tpuhevc_decision_walk"):
                raise AttributeError(name)
            return getattr(self._lib, name)

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.ctypes, "CDLL", NoWalk)
    with pytest.raises(AttributeError, match="decision_walk"):
        native.get_lib()


# --- the kernels on the card -------------------------------------------------

@pytest.mark.cuda
def test_grid_kernels_match_plain(cuda_device, base, planes):
    """G1-G6 on the card equal their plain versions on the card."""
    st = base
    dev = cuda_device
    step = st["step"]

    def c(x):
        return x.to(dev).contiguous()

    oy, ry = t(st["oy"]), t(st["ry"])
    oy2 = tile_sum(oy, 2).int()
    ry2p = step._pad_edge(tile_sum(ry[0], 2).int(), step.R2)
    args = (oy2, ry2p, step.nc, 8, 1, True)
    a = grid_coarse(c(args[0]), c(args[1]), *args[2:])
    b = grid_coarse_plain(c(args[0]), c(args[1]), *args[2:])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the +-64 prestage's level: the pick, as the step takes it
    args = (c(tile_sum(oy, 4).int()),
            c(step._pad_edge(tile_sum(ry[0], 4).int(), 16)), 33, 4, 2,
            c(step.pre_bits).int(), 1800)
    assert torch.equal(grid_prestage(*args), grid_prestage_plain(*args))
    for S, quads in ((16, True), (32, False)):
        starts = torch.stack([torch.stack([c(torch.randint(-30, 30, (
            (H // S) * (W // S),))).int() for _ in range(2)], -1)
            for _ in range(5)])
        args = (c(ry[1]), c(oy), S, H // S, W // S, starts, quads, 300, 80,
                900, 67)
        a, b = grid_refine(*args), grid_refine_plain(*args)
        for x, y in zip(a[0], b[0]):
            assert torch.equal(x, y)
        if quads:
            for x, y in zip(a[1], b[1]):
                assert torch.equal(x, y)
    for luma in (True, False):
        args = ((c(ry), True, step.PADL, step.HmL, step.WmL) if luma else
                (c(t(st["ruv"])[:, :, : W // 2]), False, step.PADC,
                 step.HmC, step.WmC))
        assert torch.equal(grid_planes(*args), grid_planes_plain(*args))
    py, pc = (c(p) for p in planes)
    mv, ref = fields(8, 5)
    for m, r in ((mv, ref), (mv[::-1], ref[::-1])):
        args = (py, pc, c(t(m)), c(t(r)), step.LOOK, step.LOOKC)
        for x, y in zip(grid_mc(*args), grid_mc_plain(*args)):
            assert torch.equal(x, y)
    lam = torch.tensor(np.float32(st["lam_me_f"]), device=dev)
    for S in (8, 16, 32, 64):
        mvS, refS = fields(S, S)
        fl = [step.cu_field(c(t(mvS)), c(t(refS)), S, st["qp"])] * 2
        for x, y in zip(grid_satd_cost(py, c(oy), fl, step.LOOK, "z", lam),
                        grid_satd_cost_plain(py, c(oy), fl, step.LOOK, "z",
                                             lam)):
            assert torch.equal(x, y), S
    tabs = tig._Tabs(tig.grid_live_tables(st["cfg"], {})[0], dev)
    pred = grid_mc(py, pc, c(t(mv)), c(t(ref)), step.LOOK, step.LOOKC)[0]
    lam = torch.tensor(st["lam"], dtype=torch.float32, device=dev)
    for T in (4, 8, 16, 32):
        for lvl8 in (True, False):
            job = (c(oy), pred, T, st["qp"], lam,
                   tabs.est_y[T.bit_length() - 1], tabs.cbf_y)
            for x, y in zip(grid_code_batch([job], lvl8)[0],
                            grid_code_plain(*job, lvl8)):
                assert torch.equal(x, y), (T, lvl8)
    nh, nw = H // 16, W // 16
    ouv = c(t(st["ouv"]))
    a = grid_intra16(c(oy), ouv, c(step.avtr_flat), c(step.avbl_flat), nh,
                     nw, cur=c(oy))
    b = grid_intra16_plain(c(oy), ouv, c(step.avtr_flat), c(step.avbl_flat),
                           nh, nw, cur=c(oy))
    for x, y in zip(a, b):
        assert torch.equal(x.int(), y.int())
    blur = c((oy + oy.roll(1, 0) + 1) >> 1)
    a = grid_intra16(blur, ouv, c(step.avtr_flat), c(step.avbl_flat), nh, nw,
                     modes=b[0].int().contiguous())
    b = grid_intra16_plain(blur, ouv, c(step.avtr_flat), c(step.avbl_flat),
                           nh, nw, modes=b[0].int())
    for x, y in zip(a, b):
        assert torch.equal(x.int(), y.int())


@pytest.mark.cuda
def test_cuda_grid_stream_equals_cpu(cuda_device, npz):
    frames = clip_frames(W, H, E2E_FRAMES)
    reset_launches()
    a, _ = encode_sequence(Reader(frames), e2e_cfg(npz, True),
                           max_frames=E2E_FRAMES, device=cuda_device)
    used = dict(LAUNCHES)
    b, _ = encode_sequence(Reader(frames), e2e_cfg(npz, True),
                           max_frames=E2E_FRAMES, device="cpu")
    assert a.bitstream() == b.bitstream()
    for k in ("grid_coarse", "grid_refine", "grid_planes", "grid_satd",
              "grid_satd_cost", "grid_code", "grid_intra16", "nnfme_mlp"):
        assert used[k] > 0, k

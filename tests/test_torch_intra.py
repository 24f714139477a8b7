"""The intra decision's device stages against the JAX package, on the CPU:

- `ops.intra.refs` + `predict_all_modes_plain` (kernel intra_bank) against
  `tpuhevc.ops.intra.predict_all_modes` on edge-padded reference arrays:
  exact, luma 4..32 with and without strong smoothing, chroma 4..16;
- `ops.cost.satd35_topk` against `satd35` + `lax.top_k` of
  `tpuhevc/codec/intra_decide_jax.py:75-84,130` (composed here from the
  same jnp operations): SATD and top-k exact, ties to the lower mode
  (flat references at S = 4, 8 and 32), the whole ranking (nc = 35) at
  S = 4..32;
- `ops.intra_txq` against `txq` of `intra_decide_jax.py:86-98` (composed
  from `tpuhevc.ops.transforms`): levels exact, dist / d0 within rtol
  1e-5, atol 1e-3 (sum order), quantiser and table RDOQ, DCT and DST;
- `entropy.bitest.tu_bits` against `ResidualBitEst.tu_bits`: bits within
  rtol 1e-5, atol 1e-3 (the port sums exactly, JAX in float32 order), with
  a Rice-boundary sweep of the CG max and of the remainders; and the
  premise of the kernel's exact integer sums (every table value a
  multiple of 2^-15, the worst-case sums below 2^31 units) at QP 0-51.

Tolerances: integer outputs must be equal; float32 sums of squares and
of fractional table bits may differ by the rounding of their sum order,
1e-5 relative (a few ulps of a 32x32 sum) and 1e-3 absolute.
The CUDA kernels against these plain versions run on a GPU only.
"""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import numpy as np
import pytest
import torch

from torch_port_util import QP, cuda_device, rng_planes  # noqa: F401
from tpuhevc.codec.intra_qt import I_ROW
from tpuhevc.entropy.bitest import FracBits, ResidualBitEst
from tpuhevc_torch.entropy.bitest import FracBits as PortFracBits
from tpuhevc_torch.entropy.bitest import ResidualBitEst as PortResidualBitEst
from tpuhevc.ops import intra as jintra
from tpuhevc.ops import transforms as jtx
from tpuhevc.utils.tables import chroma_qp
from tpuhevc_torch.entropy.bitest import (
    EstTables, est_tables, rice_bits, rice_param, tu_bits, tu_bits_plain)
from tpuhevc_torch.ops.cost import satd35_topk, satd35_topk_plain
from tpuhevc_torch.ops.intra import (
    blocks, intra_bank, predict_all_modes_plain, refs)
from tpuhevc_torch.ops.intra_txq import intra_txq, intra_txq_plain

RTOL, ATOL = 1e-5, 1e-3
LAM = 57.3  # a full I-slice lambda near QP 32 (the decision's order)


def plane_with_flat_patches(seed: int, h: int, w: int) -> np.ndarray:
    """A textured plane with flat and gently sloped 32x32 patches, so that
    32x32 luma blocks meet both sides of the strong-smoothing test."""
    p = rng_planes(seed, h, w)[0]
    xx = np.mgrid[0:h, 0:w][1]
    p[:72, :72] = 100
    p[:, 96:] = 60 + xx[:, 96:] // 8
    return p.astype(np.int32)


def np_refs(plane: np.ndarray, S: int, nh: int, nw: int):
    """`refs` of intra_decide_jax.py:66-73, in numpy."""
    pp = np.pad(plane, ((1, 2 * S), (1, 2 * S)), mode="edge")
    ys = (np.arange(nh) * S)[:, None, None]
    xs = (np.arange(nw) * S)[None, :, None]
    rng = np.arange(2 * S + 1)[None, None, :]
    return (pp[ys, xs + rng].reshape(nh * nw, -1).astype(np.int32),
            pp[ys + rng, xs].reshape(nh * nw, -1).astype(np.int32))


def bank_inputs(S: int, luma: bool, seed: int = 3):
    h, w = (96, 128) if luma else (48, 64)
    plane = (plane_with_flat_patches(seed, h, w) if luma
             else rng_planes(seed, h, w)[0])
    nh, nw = h // S, w // S
    t, l = refs(torch.from_numpy(plane), S, nh, nw)
    org = blocks(torch.from_numpy(plane[::-1].copy()), S, nh, nw)
    return plane, nh, nw, t, l, org


@pytest.mark.parametrize("S,luma,strong", [
    (4, True, True), (8, True, True), (16, True, True), (32, True, True),
    (32, True, False), (4, False, False), (8, False, False),
    (16, False, False)])
def test_intra_bank_matches_jax(S, luma, strong):
    import jax
    import jax.numpy as jnp

    plane, nh, nw, t, l, _ = bank_inputs(S, luma)
    jt, jl = np_refs(plane, S, nh, nw)
    np.testing.assert_array_equal(t.numpy(), jt)
    np.testing.assert_array_equal(l.numpy(), jl)
    want = np.asarray(jax.jit(jintra.predict_all_modes, static_argnums=(
        2, 3, 4, 5))(jnp.asarray(jt), jnp.asarray(jl), S, luma, 8, strong))
    got = intra_bank(t, l, S, luma, 8, strong)
    assert got.dtype == torch.int32 and got.shape == (nh * nw, 35, S, S)
    np.testing.assert_array_equal(got.numpy(), want)
    if S == 32 and luma:  # both sides of the flatness test are covered
        ok = jintra.strong_smoothing_ok(jt, jl, 8)
        assert 0 < ok.sum() < len(ok)


def jax_satd35_topk(org, preds, nc):
    """satd35 + top_k of intra_decide_jax.py:75-84,130 on the CPU."""
    import jax
    import jax.numpy as jnp

    from tpuhevc.ops.cost import hadamard

    def run(org, preds):
        N, S = preds.shape[0], preds.shape[-1]
        dd = (org[:, None] - preds).astype(jnp.float32)
        if S >= 8:
            Hf = jnp.asarray(hadamard(8).astype(np.float32))
            t8 = dd.reshape(N, 35, S // 8, 8, S // 8, 8).transpose(
                0, 1, 2, 4, 3, 5).reshape(-1, 8, 8)
            m = Hf @ t8 @ Hf.T
            sat = ((jnp.abs(m).sum((1, 2)) + 2) // 4).reshape(N, 35,
                                                              -1).sum(-1)
        else:
            H4 = jnp.asarray(hadamard(4).astype(np.float32))
            m = H4 @ dd.reshape(-1, 4, 4) @ H4.T
            sat = ((jnp.abs(m).sum((1, 2)) + 1) // 2).reshape(N, 35)
        return sat, jax.lax.top_k(-sat, nc)[1]

    sat, topk = jax.jit(run)(jnp.asarray(org), jnp.asarray(preds))
    return np.asarray(sat), np.asarray(topk)


@pytest.mark.parametrize("S", [4, 8, 16, 32])
def test_satd35_topk_matches_jax(S):
    _, _, _, t, l, org = bank_inputs(S, True)
    preds = predict_all_modes_plain(t, l, S)
    nc = 8 if S <= 8 else 3
    want_sat, want_topk = jax_satd35_topk(org.numpy(), preds.numpy(), nc)
    sat, topk = satd35_topk(org, preds, nc)
    np.testing.assert_array_equal(sat.numpy(), want_sat.astype(np.int32))
    np.testing.assert_array_equal(topk.numpy(), want_topk)


def test_satd35_topk_ties_take_the_lower_mode():
    """Flat references predict the same block in many modes: equal SATDs
    must rank by mode index, as top_k of the negated costs does."""
    rng = np.random.default_rng(5)
    n, S = 40, 8
    t = torch.full((n, 2 * S + 1), 0, dtype=torch.int32)
    t[:] = torch.from_numpy(rng.integers(0, 256, (n, 1)).astype(np.int32))
    org = torch.from_numpy(rng.integers(0, 256, (n, S, S)).astype(np.int32))
    org[:10] = t[:10, :1, None]  # exact: all modes cost 0
    preds = predict_all_modes_plain(t, t.clone(), S)
    for nc in (3, 8, 35):
        want_sat, want_topk = jax_satd35_topk(org.numpy(), preds.numpy(), nc)
        sat, topk = satd35_topk(org, preds, nc)
        np.testing.assert_array_equal(topk.numpy(), want_topk)
        assert (np.diff(np.sort(want_sat, 1), axis=1) == 0).any()
    np.testing.assert_array_equal(topk[:10].numpy(),
                                  np.tile(np.arange(35), (10, 1)))


@pytest.mark.parametrize("S", [4, 8, 16, 32])
def test_satd35_topk_whole_ranking_matches_jax(S):
    """nc = 35: the whole ranking of the 35 modes equals top_k's."""
    _, _, _, t, l, org = bank_inputs(S, True, seed=S + 7)
    preds = predict_all_modes_plain(t, l, S)
    want_sat, want_topk = jax_satd35_topk(org.numpy(), preds.numpy(), 35)
    sat, topk = satd35_topk(org, preds, 35)
    np.testing.assert_array_equal(sat.numpy(), want_sat.astype(np.int32))
    np.testing.assert_array_equal(topk.numpy(), want_topk)


@pytest.mark.parametrize("S", [4, 32])
def test_satd35_topk_ties_match_jax(S):
    """Flat references at S = 4 and 32: equal SATDs rank by mode index as
    top_k of the negated costs does, at nc 1, 8 and 35."""
    rng = np.random.default_rng(S)
    n = 24
    t = torch.from_numpy(np.repeat(rng.integers(0, 256, (n, 1)), 2 * S + 1,
                                   1).astype(np.int32))
    org = torch.from_numpy(rng.integers(0, 256, (n, S, S)).astype(np.int32))
    org[: n // 2] = t[: n // 2, :1, None]  # every mode costs 0
    preds = predict_all_modes_plain(t, t.clone(), S)
    for nc in (1, 8, 35):
        want_sat, want_topk = jax_satd35_topk(org.numpy(), preds.numpy(), nc)
        sat, topk = satd35_topk(org, preds, nc)
        np.testing.assert_array_equal(sat.numpy(), want_sat.astype(np.int32))
        np.testing.assert_array_equal(topk.numpy(), want_topk)
        assert (np.diff(np.sort(want_sat, 1), axis=1) == 0).any()
    np.testing.assert_array_equal(topk[: n // 2].numpy(),
                                  np.tile(np.arange(35), (n // 2, 1)))


def jax_txq(org, sel, qp, log2, rdoq, lam, est, is_dst):
    """`txq` of intra_decide_jax.py:86-98 plus the levels and d0."""
    import jax
    import jax.numpy as jnp

    def run(org, sel):
        resi = org - sel
        c = jtx.forward_transform(resi, 8, is_dst)
        if rdoq:
            lvl = jtx.rdoq_est_xp(jnp, c, qp, log2, 8, lam, est)
        else:
            lvl = jtx.quantize(c, qp, log2, 8, True)
        r = jtx.inverse_transform(jtx.dequantize(lvl, qp, log2, 8), 8,
                                  is_dst)
        err = (resi - r).astype(jnp.float32)
        d0f = resi.astype(jnp.float32)
        return ((err * err).sum(axis=(1, 2)), (d0f * d0f).sum(axis=(1, 2)),
                lvl, est.tu_bits(jnp, lvl))

    return tuple(np.asarray(x) for x in jax.jit(run)(jnp.asarray(org),
                                                     jnp.asarray(sel)))


@pytest.mark.parametrize("rdoq", [False, True])
@pytest.mark.parametrize("S,luma", [(4, True), (8, True), (16, True),
                                    (32, True), (4, False), (8, False),
                                    (16, False)])
def test_intra_txq_and_tu_bits_match_jax(S, luma, rdoq):
    _, nh, nw, t, l, org = bank_inputs(S, luma, seed=S)
    preds = predict_all_modes_plain(t, l, S, luma)
    nc = 5
    _, topk = satd35_topk_plain(org, preds, nc)
    n = org.shape[0]
    rows = torch.arange(n, dtype=torch.int32)
    qp = QP if luma else chroma_qp(QP)
    lam = LAM if luma else LAM / 2.0 ** ((QP - qp) / 3.0)
    log2 = S.bit_length() - 1
    fb = FracBits(I_ROW, QP)
    est = ResidualBitEst(fb, log2, luma)
    et = est_tables(PortFracBits(I_ROW, QP), log2, luma, "cpu")
    is_dst = luma and S == 4
    dist, d0, lvl = intra_txq(org, preds, rows, topk, qp, is_dst, rdoq, lam,
                              et)
    bits = tu_bits(et, lvl.reshape(-1, S, S)).reshape(n, nc)
    sel = np.take_along_axis(preds.numpy(), topk.numpy()[:, :, None, None]
                             .astype(np.int64), 1)
    want = jax_txq(np.repeat(org.numpy()[:, None], nc, 1).reshape(-1, S, S),
                   sel.reshape(-1, S, S), qp, log2, rdoq, lam, est, is_dst)
    np.testing.assert_array_equal(lvl.reshape(-1, S, S).numpy(), want[2])
    for got, w in zip((dist, d0, bits), (want[0], want[1], want[3])):
        np.testing.assert_allclose(got.reshape(-1).numpy(), w, rtol=RTOL,
                                   atol=ATOL)
    assert (want[2] != 0).any()  # coded TUs (and, for luma, uncoded ones)
    assert not luma or (want[2] == 0).all(axis=(1, 2)).any()


def test_intra_txq_reads_banks_through_rows():
    """The TU-split trial addresses child banks in place: rows/modes
    select the same TUs as a gathered copy would."""
    _, _, _, t, l, org = bank_inputs(8, True)
    preds = predict_all_modes_plain(t, l, 8)
    rng = np.random.default_rng(2)
    rows = torch.from_numpy(rng.integers(0, len(org), 50).astype(np.int32))
    modes = torch.from_numpy(rng.integers(0, 35, (50, 1)).astype(np.int32))
    et = est_tables(PortFracBits(I_ROW, QP), 3, True, "cpu")
    a = intra_txq(org, preds, rows, modes, QP, False, True, LAM, et)
    r = rows.long()
    b = intra_txq(org[r].contiguous(), preds[r].contiguous(),
                  torch.arange(50, dtype=torch.int32), modes, QP, False, True,
                  LAM, et)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def rice_sweep_tiles(S: int) -> np.ndarray:
    """Level tiles whose CG maxima straddle 3 * 2^k (k = 0..5) and whose
    remainders |l| - 2 straddle 3 * 2^k and the escape's powers of two."""
    rng = np.random.default_rng(S)
    cg_max = sorted({v for k in range(6) for v in (3 << k) - 1 + np.arange(3)})
    rems = sorted({v for k in range(7) for v in (3 << k) + np.arange(-1, 2)}
                  | {3 * 2 ** k + (1 << j) * 2 ** k - 1 + d
                     for k in range(5) for j in range(9) for d in (0, 1)})
    out = []
    for m in cg_max:
        for r in rems[:: max(1, len(rems) // 12)]:
            t = rng.integers(-2, 3, (S, S))
            t.flat[rng.integers(0, S * S)] = m * rng.choice((-1, 1))
            t.flat[rng.integers(0, S * S)] = min(r + 2, m) * rng.choice((-1, 1))
            out.append(t)
    for r in rems:  # every remainder, alone in its CG
        t = np.zeros((S, S), np.int64)
        t[0, 0] = r + 2
        out.append(t)
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("S,luma", [(4, True), (8, True), (16, True),
                                    (32, True), (4, False), (8, False),
                                    (16, False)])
def test_tu_bits_matches_jax(S, luma):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(S + 7 * luma)
    dense = rng.integers(-3, 4, (60, S, S)) * (
        rng.random((60, S, S)) < rng.random((60, 1, 1)) ** 2)
    dense[:20] *= rng.integers(1, 60, (20, 1, 1))
    dense[20] = 0
    tiles = np.concatenate([dense.astype(np.int32), rice_sweep_tiles(S)])
    log2 = S.bit_length() - 1
    fb = FracBits(I_ROW, QP)
    est = ResidualBitEst(fb, log2, luma)
    want = np.asarray(jax.jit(lambda x: est.tu_bits(jnp, x))(
        jnp.asarray(tiles)))
    got = tu_bits(est_tables(PortFracBits(I_ROW, QP), log2, luma, "cpu"),
                  torch.from_numpy(tiles))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert got[20] == 0


def test_rice_formulas_match_jax_across_boundaries():
    """The Rice parameter and the escape length are exact integer
    formulas; JAX's float log2 gives the same below 2^13 (XLA rounds
    log2(2^13) and log2(2^15) just below the integer, so the two differ
    there, at levels the decision never meets at its QPs)."""
    import jax
    import jax.numpy as jnp

    from tpuhevc.entropy.bitest import _rice_bits_xp

    c = np.arange(0, 20000, dtype=np.int32)
    want = np.asarray(jax.jit(lambda c: jnp.clip(jnp.where(
        c > 6, jnp.log2(jnp.maximum(c, 1).astype(jnp.float32) / 3.0), 0.0),
        0, 4).astype(jnp.int32))(c))
    np.testing.assert_array_equal(rice_param(torch.from_numpy(c)).numpy(),
                                  want)
    for k in range(5):
        rem = np.arange(1, 3 * (1 << k) + (8190 << k), dtype=np.int32)
        want = np.asarray(jax.jit(lambda r, k: _rice_bits_xp(jnp, r, k))(
            jnp.asarray(rem), jnp.full(rem.shape, k, jnp.int32)))
        got = rice_bits(torch.from_numpy(rem), torch.full(rem.shape, k))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # exact where XLA's log2 is not: (rem - 3*2^k) >> k = 2^13 - 1
    got = rice_bits(torch.tensor([3 + 8191]), torch.tensor([0]))
    assert int(got[0]) == 4 + 2 * 13


@pytest.mark.parametrize("log2,luma", [(g, c) for c in (True, False)
                                        for g in (2, 3, 4, 5)])
def test_tu_bits_fixed_point_premise(log2, luma):
    """The premise of the kernel's exact integer sums, for QP 0-51 over
    each init row the port builds tables for (B 0, P 1, I 2): every cost
    table value times 2^15 is an integer, and the worst-case csbf, sig
    and gt1/gt2 sums stay below 2^31 units of 2^-15 (so the kernel sums
    in int32)."""
    ncg = max(1, (1 << log2) >> 2) ** 2
    for row in (0, 1, 2):
        for qp in range(52):
            est = PortResidualBitEst(PortFracBits(row, qp), log2, luma)
            q = EstTables(est, "cpu").ftab.double() * 32768
            assert torch.equal(q, q.round()), (row, qp)
            u = {k: np.asarray(getattr(est, k), np.float64) * 32768
                 for k in PortResidualBitEst.COST_FIELDS}
            # a CG's gt1/gt2 bits: 8 gt1 bins and the gt2 bin at their
            # dearest, below 2^24 (exact in float32, as the plain version
            # takes them)
            cg_b12 = max(8 * u[g1].max() + u[g2].max()
                         for g1, g2 in (("gt1_bits", "gt2_bits"),
                                        ("gt1_bits0", "gt2_bits0")))
            worst = (ncg * u["csbf_bits"].max(),  # every CG's flag
                     u["sig_bits"].max(axis=(0, 3)).sum(),  # every position
                     ncg * cg_b12)
            assert cg_b12 < 1 << 24 and max(worst) < 1 << 31, (row, qp)


@pytest.mark.cuda
@pytest.mark.parametrize("S,luma", [(4, True), (8, True), (16, True),
                                    (32, True), (4, False), (8, False),
                                    (16, False)])
def test_intra_kernels_match_plain(cuda_device, S, luma):
    """intra_bank, satd35_topk, intra_txq (quantiser and RDOQ) and
    tu_bits on the card against their plain versions on the same card:
    integers, intra_txq's SSEs and tu_bits' float32 bits (exact sums
    rounded once) equal."""
    _, _, _, t, l, org = bank_inputs(S, luma, seed=S + 1)
    t, l, org = t.to(cuda_device), l.to(cuda_device), org.to(cuda_device)
    for strong in (False, True):
        got = intra_bank(t, l, S, luma, 8, strong)
        want = predict_all_modes_plain(t, l, S, luma, 8, strong)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    preds = got
    nc = 8 if S <= 8 else 3
    got = satd35_topk(org, preds, nc)
    want = satd35_topk_plain(org, preds, nc)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    topk = got[1]
    rows = torch.arange(org.shape[0], dtype=torch.int32, device=cuda_device)
    log2 = S.bit_length() - 1
    et = est_tables(PortFracBits(I_ROW, QP), log2, luma, cuda_device)
    qp = QP if luma else chroma_qp(QP)
    for rdoq in (False, True):
        args = (org, preds, rows, topk, qp, luma and S == 4, rdoq, LAM, et)
        got = intra_txq(*args)
        want = intra_txq_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):  # the SSEs are exact integer sums
            assert torch.equal(g, w)
        tiles = got[2].reshape(-1, S, S)
        assert torch.equal(tu_bits(et, tiles), tu_bits_plain(et, tiles))
    sweep = torch.from_numpy(rice_sweep_tiles(S)).to(cuda_device)
    assert torch.equal(tu_bits(et, sweep), tu_bits_plain(et, sweep))


@pytest.mark.cuda
def test_cuda_intra_txq_equals_plain(cuda_device):
    """intra_txq (a team of lanes a TU, many TUs a block) against its
    plain version with torch.equal at S 4-32, luma and chroma, the DST at
    4x4 luma, RDOQ on and off, K 1, 3 and 5 candidates, TU counts that do
    not fill the last block, and rows that read children's banks in
    place (repeated and out of order, as the TU-split trial reads
    them)."""
    rng = np.random.default_rng(11)
    for S, luma in ((4, True), (8, True), (16, True), (32, True),
                    (4, False), (8, False), (16, False)):
        _, _, _, t, l, org = bank_inputs(S, luma, seed=S + 5)
        preds = predict_all_modes_plain(t, l, S, luma).to(cuda_device)
        org = org.to(cuda_device)
        et = est_tables(PortFracBits(I_ROW, QP), S.bit_length() - 1, luma,
                        cuda_device)
        qp = QP if luma else chroma_qp(QP)
        lam = LAM if luma else LAM / 2.0 ** ((QP - qp) / 3.0)
        n = org.shape[0]
        for m, K in ((n, 1), (13, 3), (n - 1, 5)):
            rows = torch.as_tensor(rng.permutation(n)[:m] if K != 3 else
                                   rng.integers(0, n, m),
                                   dtype=torch.int32, device=cuda_device)
            modes = torch.as_tensor(rng.integers(0, 35, (m, K)),
                                    dtype=torch.int32, device=cuda_device)
            for rdoq in (False, True):
                args = (org, preds, rows, modes, qp, luma and S == 4, rdoq,
                        lam, et)
                got, want = intra_txq(*args), intra_txq_plain(*args)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and torch.equal(g, w), (S, K)
                assert bool((got[2] != 0).any())

"""K2 over the grid's classes in one launch (`models/nnfme.py:
nn_refine_classes`) and the SAO decision (`ops/grid_sao.py:
grid_sao_decide`). JAX is imported only inside the tests that compare
with it, so that the `cuda` tests load where only the GPU stack is.

On the CPU:
- `nn_refine_classes`' plain path over three classes (S = 16, 8, 32 with
  48, 192 and 12 PUs), and over an empty class beside another, equals
  `tpuhevc.models.nnfme.forward`, then the argmax and `CLASS_TO_QMV` (JAX
  on the CPU), class by class: the offsets equal;
- two equal rows of `Wout` and `bout` that hold every PU's maximum: the
  lower class wins in the plain version and in JAX's;
- the wrappers refuse a tensor that is on neither the CPU nor a card,
  and `nn_refine_classes` no class or more than a launch takes (3); its
  classes equal `nn_refine`'s one by one.

On a card (`cuda`; skipped here):
- K2 against the plain version at n = 1, 31, 32, 33 and 5,000 PUs, with
  the logits written (`nn_refine`) and without (`nn_refine_classes`):
  logits within atol 1e-4 / rtol 1e-5 (the plain version sums its matrix
  products in another order), classes and offsets equal wherever the
  plain top-2 gap exceeds 1e-3, the class the first maximum of the
  kernel's own logits everywhere, and the two paths' offsets equal;
- the grid's three classes of a 416x240 picture in one launch (with an
  empty class beside them), equal to one launch a class, also where two
  classes tie (the most frequent winner's row of `Wout` and `bout`
  copied into a lower class's: the lower class wins);
- `grid_sao_decide` against its plain version (`torch.equal` of `par`
  and the parameter rows) on CTU grids 1x1, 2x3, 4x7, 5x7, 17x30 and
  34x60 at three lambdas (the picture's choice on and off);
- all-zero statistics (every candidate ties), and two launches back to
  back without a sync between, each equal to plain, the ticket left at 0;
- two launches on two streams of one card, not synchronised between:
  each has its own cost scratch and ticket, each equals plain.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, write_weights  # noqa: F401
from tpuhevc_torch.kernels import LAUNCHES
from tpuhevc_torch.models.nnfme import (
    NNFME, height_category, load_npz, nn_refine, nn_refine_classes,
    random_params, select_qp_params, width_category)
from tpuhevc_torch.ops import grid_sao as gs

# the grid's classes at 416x240: (S, PUs)
GRID_CLASSES = ((16, 390), (8, 1560), (32, 91))


def sad_surfaces(seed, n):
    """(n, 9) int32 SAD surfaces around a minimum, at 8-bit block scale."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(200, 6000, (n, 1))
    bowl = rng.uniform(0.0, 0.6, (n, 9)) * base
    bowl[:, 4] = 0
    return np.rint(base + bowl).astype(np.int32)


def parts_of(classes, seed, dev):
    return [(torch.as_tensor(sad_surfaces(seed + k, n), device=dev),
             height_category(S), width_category(S))
            for k, (S, n) in enumerate(classes)]


def jax_offsets(p, parts):
    """tpuhevc's forward, argmax and CLASS_TO_QMV, class by class."""
    import jax.numpy as jnp

    from tpuhevc.models import nnfme as jn

    out = []
    for sad9, hc, wc in parts:
        n = sad9.shape[0]
        logits = jn.forward({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(sad9.numpy()).astype(jnp.float32),
                            jnp.full(n, hc), jnp.full(n, wc))
        out.append(jn.CLASS_TO_QMV[np.asarray(jnp.argmax(logits, -1))]
                   .reshape(n, 2))
    return out


def test_classes_match_jax(tmp_path):
    from tpuhevc.models import nnfme as jn

    p = jn.select_qp_params(jn.load_npz(write_weights(tmp_path / "w.npz")),
                            32)
    model = NNFME.from_numpy(select_qp_params(
        load_npz(str(tmp_path / "w.npz")), 32), "cpu")
    seen = []
    for classes in (((16, 48), (8, 192), (32, 12)), ((8, 0), (32, 20))):
        parts = parts_of(classes, 5, "cpu")
        got = nn_refine_classes(model, parts)
        want = jax_offsets(p, parts)
        assert [tuple(g.shape) for g in got] == [(n, 2) for _, n in classes]
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
            seen.append(g.numpy())
    assert len(np.unique(np.concatenate(seen), axis=0)) > 1


def tie_params(seed, lo, hi):
    """Seeded weights whose output rows lo and hi are zero with an equal
    bias far above every other logit: the two classes tie at every PU,
    exactly, in any summation order."""
    p = random_params(seed)
    for c in (lo, hi):
        p["wout"][c] = 0.0
        p["bout"][c] = 1000.0
    return p


def test_ties_lower_class_wins():
    from tpuhevc.models import nnfme as jn

    lo, hi = 12, 30
    p = tie_params(2, lo, hi)
    parts = parts_of(((16, 40), (8, 40)), 9, "cpu")
    got = nn_refine_classes(NNFME.from_numpy(p, "cpu"), parts)
    want = jax_offsets(p, parts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(
            g.numpy(), np.tile(jn.CLASS_TO_QMV[lo], (len(w), 1)))
    _, cls, _ = nn_refine(NNFME.from_numpy(p, "cpu"), *parts[0])
    assert (cls == lo).all()


def test_wrappers_refuse_other_devices_and_class_counts():
    meta = torch.device("meta")
    model = NNFME.from_numpy(random_params(0), "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        nn_refine_classes(NNFME.from_numpy(random_params(0), meta), [
            (torch.empty(3, 9, dtype=torch.int32, device=meta), 2, 2)])
    cnt = torch.empty(3, 2, 48, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        gs.grid_sao_decide(cnt, cnt, torch.empty((), device=meta), 32, 1, 2)
    # one launch takes one to three classes, on either device
    parts = parts_of(((16, 7), (8, 9), (32, 3), (16, 5)), 3, "cpu")
    for bad in ([], parts):
        with pytest.raises(ValueError, match="classes"):
            nn_refine_classes(model, bad)
    got = nn_refine_classes(model, parts[1:])
    for g, (sad9, hc, wc) in zip(got, parts[1:]):
        assert torch.equal(g, nn_refine(model, sad9, hc, wc)[2])


def check_against_plain(model, sad9, hc, wc, kl, kc, kq):
    """K2's outputs on one class against the plain version."""
    pl, pc, pq = nn_refine(model.cpu(), sad9.cpu(), hc, wc)
    kl, kc, kq = kl.cpu(), kc.cpu(), kq.cpu()
    torch.testing.assert_close(kl, pl, atol=1e-4, rtol=1e-5)
    top2 = torch.topk(pl, 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(kc[clear], pc[clear])
    assert torch.equal(kq[clear], pq[clear])
    # the first maximum of the kernel's own logits, everywhere
    assert torch.equal(kc, torch.argmax(kl, 1).int())
    assert torch.equal(kq, model.cls_to_qmv.cpu()[kc.long()])


@pytest.mark.cuda
def test_cuda_k2_matches_plain(cuda_device):
    model = NNFME.from_numpy(random_params(1), cuda_device)
    host = NNFME.from_numpy(random_params(1), "cpu")
    for n in (1, 31, 32, 33, 5000):
        for S in (8, 16, 32):
            hc, wc = height_category(S), width_category(S)
            sad9 = torch.as_tensor(sad_surfaces(n + S, n), device=cuda_device)
            kl, kc, kq = nn_refine(model, sad9, hc, wc)
            (off,) = nn_refine_classes(model, [(sad9, hc, wc)])
            torch.cuda.synchronize()
            check_against_plain(host, sad9, hc, wc, kl, kc, kq)
            assert torch.equal(off, kq)


@pytest.mark.cuda
def test_cuda_k2_grid_classes_in_one_launch(cuda_device):
    plain = random_params(4)
    # the tie: the most frequent winning class copied into a lower one
    host = NNFME.from_numpy(plain, "cpu")
    won = torch.cat([nn_refine(host, s.cpu(), hc, wc)[1]
                     for s, hc, wc in parts_of(GRID_CLASSES, 11, "cpu")])
    hi = int(torch.bincount(won.long(), minlength=49)[1:].argmax()) + 1
    lo = hi // 2
    tied = random_params(4)
    tied["wout"][lo] = tied["wout"][hi]
    tied["bout"][lo] = tied["bout"][hi]
    # the grid's classes; an empty class beside two others
    for p, classes in ((plain, GRID_CLASSES), (tied, GRID_CLASSES),
                       (plain, ((16, 0), (8, 33), (32, 91)))):
        model = NNFME.from_numpy(p, cuda_device)
        parts = parts_of(classes, 11, cuda_device)
        before = LAUNCHES["nnfme_mlp"]
        offs = nn_refine_classes(model, parts)
        assert LAUNCHES["nnfme_mlp"] - before == 1
        for off, (sad9, hc, wc) in zip(offs, parts):
            kl, kc, kq = nn_refine(model, sad9, hc, wc)
            torch.cuda.synchronize()
            assert torch.equal(off, kq)
            if sad9.shape[0]:
                check_against_plain(NNFME.from_numpy(p, "cpu"), sad9, hc,
                                    wc, kl, kc, kq)
        if p is tied:  # an exact tie in the kernel: the lower class wins
            kl, kc, _ = nn_refine(model, *parts[1])
            top = kl.max(1).values
            both = (kl[:, lo] == top) & (kl[:, hi] == top)
            assert int(both.sum()) > 0 and (kc[both] == lo).all()


def sao_stats(ny, nx, seed, zero=False):
    """(cnt, sm) (3, ny nx, 48) int32: counts up to a 64x64 CTU's, sums of
    org - rec at up to +-12 a sample."""
    rng = np.random.default_rng(seed)
    shape = (3, ny * nx, 48)
    if zero:
        return (np.zeros(shape, np.int32),) * 2
    cnt = rng.integers(0, 1200, shape) * (rng.random(shape) < 0.8)
    sm = np.rint(cnt * rng.uniform(-12, 12, shape)).astype(np.int64)
    return cnt.astype(np.int32), sm.astype(np.int32)


def decide(dev, cnt, sm, lam, qp, ny, nx):
    """The kernel's (par, prm) and a function that gives the plain's."""
    args = [torch.as_tensor(x, device=dev) for x in (cnt, sm)]
    lam_t = torch.tensor(np.float32(lam), device=dev)
    out = gs.grid_sao_decide(*args, lam_t, qp, ny, nx)

    def plain():
        return gs.grid_sao_decide_plain(*[a.cpu() for a in args],
                                        lam_t.cpu(), qp, ny, nx)
    return out, plain


def assert_equal_plain(out, plain):
    (par, prm), (ppar, pprm) = out, plain()
    assert torch.equal(par.cpu(), ppar) and torch.equal(prm.cpu(), pprm)
    return ppar


@pytest.mark.cuda
def test_cuda_sao_decide_matches_plain(cuda_device):
    for ny, nx in ((1, 1), (2, 3), (4, 7), (5, 7), (17, 30), (34, 60)):
        configs = set()
        for k, lam in enumerate((2.5, 57.0, 40000.0)):
            cnt, sm = sao_stats(ny, nx, 100 * ny + nx + k)
            ppar = assert_equal_plain(*decide(cuda_device, cnt, sm, lam,
                                              32 + k, ny, nx))
            n = ny * nx
            configs.add((bool((ppar[0, :n] >= 0).any()),
                         bool((ppar[1, :n] >= 0).any())))
        # the picture's choice turned a component off at some lambda
        assert len(configs) > 1, (ny, nx)


@pytest.mark.cuda
def test_cuda_sao_decide_ties_and_back_to_back(cuda_device):
    cnt, sm = sao_stats(4, 7, 0, zero=True)
    assert_equal_plain(*decide(cuda_device, cnt, sm, 57.0, 32, 4, 7))
    # two launches queued back to back, no sync between: each finds the
    # ticket at 0
    ra = decide(cuda_device, *sao_stats(17, 30, 1), 30.0, 37, 17, 30)
    rb = decide(cuda_device, *sao_stats(4, 7, 2), 30.0, 37, 4, 7)
    for r in (ra, rb):
        assert_equal_plain(*r)
    key = (cuda_device.index, torch.cuda.current_stream(cuda_device)
           .cuda_stream)
    assert int(gs._DECIDE_SCRATCH[key][1].item()) == 0


@pytest.mark.cuda
def test_cuda_sao_decide_two_streams(cuda_device):
    """Two launches on two streams of one card, not synchronised between:
    each stream has its own cost scratch and ticket, each launch equals
    plain, each ticket is left at 0."""
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    stats = [sao_stats(34, 60, 7), sao_stats(34, 60, 8)]
    for rep in range(3):
        outs = []
        for (cnt, sm), stream, lam in zip(stats, streams, (30.0, 57.0)):
            with torch.cuda.stream(stream):
                outs.append(decide(cuda_device, cnt, sm, lam + rep, 37, 34,
                                   60))
        torch.cuda.synchronize()
        for r in outs:
            assert_equal_plain(*r)
    scratch = [gs._DECIDE_SCRATCH[cuda_device.index, s.cuda_stream]
               for s in streams]
    assert scratch[0][0].data_ptr() != scratch[1][0].data_ptr()
    assert all(int(x[1].item()) == 0 for x in scratch)

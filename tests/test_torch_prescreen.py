"""The multi-device path's intra prescreen over a device's row stripes
(kernel `stripe_prescreen`, `ops/stripe_prescreen.py`) on the CPU.
Imports no JAX and compiles nothing.

- `stripe_prescreen_rows_plain` over k consecutive stripes (k = 1, 2, 3,
  8) equals `stripe_prescreen_plain` stripe by stripe, the halo of each
  later stripe the row above it and that of the first the given row or
  mid-grey: modes and costs exact, at widths 416, 128 and 72 (a run of 4
  blocks that ends one block into its last run), bit depths 8 and 10, on
  seeded noise and on flat planes at 0 and at the maximum;
- `stripe_prescreen` is its one-stripe case, and refuses a device that is
  neither the CPU nor CUDA;
- `tile_prescreen` on a mesh of 3 x cpu takes the three stripes as one
  group (`parallel/mesh.py:_groups`) and equals them stripe by stripe.

`tests/test_torch_parallel.py` holds `tile_prescreen` against tpuhevc's
and, on the card, the kernel against plain at these cases (PRESCREEN_CASES).
"""

import numpy as np
import pytest
import torch

from tpuhevc_torch.ops.stripe_prescreen import (
    stripe_prescreen, stripe_prescreen_plain, stripe_prescreen_rows_plain)
from tpuhevc_torch.parallel import mesh

# (width, stripe rows, stripes, bit depth, plane, halo): plane "noise" is
# seeded noise, "zero" / "max" flat at 0 / (1 << bd) - 1; halo "mid" the
# picture's first stripe (none given), "row" a seeded row above
PRESCREEN_CASES = (
    (416, 16, 3, 8, "noise", "mid"),
    (128, 16, 8, 8, "noise", "row"),
    (72, 8, 2, 8, "noise", "mid"),
    (72, 24, 1, 10, "noise", "row"),
    (128, 16, 2, 8, "zero", "mid"),
    (128, 8, 3, 10, "max", "row"),
)


def prescreen_case(w, hl, k, bd, kind, halo, seed=0):
    """-> (rows (k hl, w), halo (1, w) or None) int32 on the CPU."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    if kind == "noise":
        rows = rng.integers(0, maxv + 1, (k * hl, w))
    else:
        rows = np.full((k * hl, w), 0 if kind == "zero" else maxv)
    above = rng.integers(0, maxv + 1, (1, w)) if halo == "row" else None
    return (torch.as_tensor(rows, dtype=torch.int32),
            None if above is None else torch.as_tensor(above,
                                                       dtype=torch.int32))


def per_stripe(rows, halo, hl, bd):
    """stripe_prescreen_plain on each stripe of rows, each later halo the
    row above it, concatenated."""
    w = rows.shape[1]
    out = []
    for j in range(rows.shape[0] // hl):
        top = (rows[j * hl - 1 : j * hl] if j else
               torch.full((1, w), 1 << (bd - 1), dtype=torch.int32)
               if halo is None else halo)
        out.append(stripe_prescreen_plain(rows[j * hl : (j + 1) * hl], top,
                                          bd))
    return tuple(torch.cat([o[i] for o in out]) for i in range(2))


@pytest.mark.parametrize("case", PRESCREEN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_rows_plain_equals_stripe_by_stripe(case):
    w, hl, k, bd = case[:4]
    rows, halo = prescreen_case(*case)
    got = stripe_prescreen_rows_plain(rows, halo, hl, bd)
    want = per_stripe(rows, halo, hl, bd)
    for g, x, what in zip(got, want, ("mode", "cost")):
        assert g.shape == (k * hl // 8, w // 8), what
        assert torch.equal(g, x), what
    assert bool(((got[0] >= 0) & (got[0] < 35)).all())
    if case[4] != "noise":  # a flat block: DC-like modes cost 0 inside
        assert int(got[1].min()) == 0


def test_one_stripe_case_and_refusals():
    rows, halo = prescreen_case(72, 24, 1, 8, "noise", "row", seed=3)
    for g, x in zip(stripe_prescreen(rows, halo),
                    stripe_prescreen_plain(rows, halo)):
        assert torch.equal(g, x)
    mid = torch.full((1, 72), 128, dtype=torch.int32)
    for g, x in zip(stripe_prescreen(rows, None),
                    stripe_prescreen_plain(rows, mid)):
        assert torch.equal(g, x)
    with pytest.raises(ValueError, match="unsupported device"):
        stripe_prescreen(rows.to("meta"), None)


def test_tile_prescreen_groups_a_device():
    m = mesh.make_mesh(3, device="cpu")
    assert [tuple(g[1:]) for g in mesh._groups(m)] == [(0, 3)]
    rows, _ = prescreen_case(128, 16, 3, 8, "noise", "mid", seed=5)
    got = mesh.tile_prescreen(m, 48, 128)(rows)
    for g, x in zip(got, per_stripe(rows, None, 16, 8)):
        assert torch.equal(g, x)

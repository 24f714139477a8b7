"""The per-picture P path's host tool stage: tpuhevc_torch's
`inter_enc._compute_stage_np` against tpuhevc's (numpy on both sides, so
no JAX compile), array by array of the per-CU dict, and the stage choice
of `encode_frame_p`.

- 112x72 (every CU class: 32s with their 16s, free 16s, 8x8 borders) and
  72x40 (8x8 border classes at a height of 8 mod 16), with RDOQ, sign
  hiding and DCT-IF refinement; with FmeMode nn and seeded weights; with a
  two-QP `ctu_qp_map` (the per-block QP groups), with RDOQ and without;
- `encode_frame_p` takes the host stage for DCT-IF, sign hiding, RDOQ or a
  QP map whatever the device (no card needed), and the device stage
  otherwise, which raises on an absent CUDA device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_util import clip_frames, ldp_cfg
from tpuhevc_torch.codec import inter_enc as tie
from tpuhevc_torch.codec.params import p_frame_lambda
from tpuhevc_torch.codec.recon import _pad_to
from tpuhevc_torch.models.nnfme import random_params

# name: (w, h, fme_mode, rdoq, two-QP map)
CASES = {
    "112x72_rdoq_sbh_dctif": (112, 72, "dctif", True, False),
    "72x40_rdoq_sbh_dctif": (72, 40, "dctif", True, False),
    "112x72_rdoq_sbh_nn": (112, 72, "nn", True, False),
    "72x40_rdoq_sbh_nn": (72, 40, "nn", True, False),
    "112x72_qp_map_rdoq_sbh_nn": (112, 72, "nn", True, True),
    "72x40_qp_map_sbh_nn": (72, 40, "nn", False, True),
}
QP_P = 35  # the anchor's first P picture: QP 32 + 3


def stage_inputs(w, h):
    """Picture 1 against picture 0 of the seeded clip, padded as
    `encode_frame_p` pads them, int32."""
    frames = clip_frames(w, h, 2)
    pad = [tuple(_pad_to(np.asarray(p), h >> s, w >> s).astype(np.int32)
                 for p, s in zip(f, (0, 1, 1))) for f in frames]
    return pad[1], pad[0]


def two_qp_map(w, h):
    """Per-CTU QPs alternating 33 and 37 (CTU 64)."""
    hc, wc = -(-h // 64), -(-w // 64)
    return np.where((np.arange(hc)[:, None] + np.arange(wc)[None]) % 2,
                    37, 33).astype(np.int32)


def configs(w, h, fme, rdoq, qmap):
    out = []
    for port in (False, True):
        cfg = ldp_cfg(None, w, h, port=port, fme_mode=fme, rdoq=rdoq,
                      **({} if port else {"backend": "np"}))
        cfg.pps.sign_data_hiding = True
        cfg = dataclasses.replace(
            cfg, qp=QP_P, frame_lambda=p_frame_lambda(cfg, 0, QP_P),
            ctu_qp_map=two_qp_map(w, h) if qmap else None)
        out.append(cfg)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_stage_matches_tpuhevc(name):
    from tpuhevc.codec import inter_enc as jie

    w, h, fme, rdoq, qmap = CASES[name]
    jcfg, tcfg = configs(w, h, fme, rdoq, qmap)
    orig, ref = stage_inputs(w, h)
    nn = random_params(0) if fme == "nn" else None
    lambda_fp = int(round(np.sqrt(tcfg.frame_lambda) * 256))
    want = jie._compute_stage_np(jcfg, orig, ref, nn, lambda_fp)
    got = tie._compute_stage_np(tcfg, orig, ref, nn, lambda_fp)
    assert got.keys() == want.keys()
    sizes = set()
    for pos, cu in want.items():
        assert got[pos].keys() == cu.keys(), pos
        sizes.add(cu["size"])
        for key, v in cu.items():
            g = np.asarray(got[pos][key])
            v = np.asarray(v)
            assert g.dtype == v.dtype, (pos, key)
            np.testing.assert_array_equal(g, v, err_msg=f"{pos} {key}")
    assert 8 in sizes and len(sizes) > 1  # border classes and larger CUs
    assert any(cu["lvl"].any() for cu in want.values())  # residual coded
    if fme == "dctif":
        assert any((cu["mv"] % 4).any() for cu in want.values())


def test_stage_choice(monkeypatch):
    """The configuration chooses the stage: DCT-IF, sign hiding, RDOQ or a
    QP map take the host stage on any device (the same picture on "cuda"
    without a card as on "cpu"); the tools off take the device stage,
    which raises where CUDA is absent."""
    w, h = 72, 40
    orig, ref = stage_inputs(w, h)
    base = ldp_cfg(None, w, h, port=True)
    base = dataclasses.replace(base, qp=QP_P,
                               frame_lambda=p_frame_lambda(base, 0, QP_P))
    assert not tie.host_stage(base)
    host = [dataclasses.replace(base, fme_mode="dctif"),
            dataclasses.replace(base, rdoq=True),
            dataclasses.replace(base, ctu_qp_map=two_qp_map(w, h))]
    sbh = ldp_cfg(None, w, h, port=True)
    sbh.pps.sign_data_hiding = True
    host.append(dataclasses.replace(sbh, qp=QP_P,
                                    frame_lambda=base.frame_lambda))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in host:
        assert tie.host_stage(cfg)
        fs_a, rec_a = tie.encode_frame_p(orig, ref, cfg, device="cuda")
        fs_b, rec_b = tie.encode_frame_p(orig, ref, cfg, device="cpu")
        assert all(np.array_equal(a, b) for a, b in zip(rec_a, rec_b))
        assert np.array_equal(fs_a.coeff_y, fs_b.coeff_y)
    with pytest.raises(RuntimeError, match="CUDA"):
        tie.encode_frame_p(orig, ref, base, device="cuda")

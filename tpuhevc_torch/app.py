"""CLI of the port: `enc` runs the all-intra, LD-P or random-access slice
through the CUDA kernels; `dec` is the port's host decoder (a copy of the
reference's; every picture's MD5 SEI is checked); `extract` and `train`
make NN-FME weights.

Usage:
  python -m tpuhevc_torch enc -c cfg/encoder_intra_main.cfg \
      -i in.yuv -b out.bin -o rec.yuv -wdt 416 -hgt 240 -f 3 -q 32 \
      [--Device=cuda]
  python -m tpuhevc_torch enc -c cfg/encoder_lowdelay_P_main.cfg \
      -i in.yuv -b out.bin -o rec.yuv -wdt 416 -hgt 240 -f 17 -q 32 \
      --NNWeightsDir=weights.npz [--Device=cuda]
  python -m tpuhevc_torch enc -c cfg/encoder_randomaccess_main.cfg \
      -i in.yuv -b out.bin -o rec.yuv -wdt 416 -hgt 240 -f 18 -q 32 \
      --NNWeightsDir=weights.npz [--Device=cuda]
  python -m tpuhevc_torch enc -c cfg/encoder_lowdelay_P_main.cfg \
      -i in.yuv -b out.bin -wdt 416 -hgt 240 -f 32 -q 32 \
      --SEIDecodedPictureHash=3 [--Device=cuda]
  python -m tpuhevc_torch dec -b out.bin -o dec.yuv
  python -m tpuhevc_torch extract data_q32.csv [--input clip.yuv] \
      [--width 416] [--height 240] [--frames 16] [--qp 32]
  python -m tpuhevc_torch train weights.npz --data data_q32.csv:32 \
      [--data data_q22.csv:22 ...] [--epochs 200] [--lr 3e-3] [--Device=cuda]

`extract` and `train` are the counterparts of tools/extract_fme_dataset.py
and tools/train_fme.py: the NN-FME dataset (host numpy; with no --input,
tools/make_test_clip.py's seeded clip) as the same CSV, then one MLP per
QP trained on the card (the train step's kernels) into the same npz
layout, which `--NNWeightsDir=` reads.

Options are HM's syntax, as the reference's CLI reads them; `--Device=`
names the torch device (default cuda; there is no fallback to the CPU).
`--FmeMode=dctif` and `--WeightedPredP=1` run on the LD-P grid;
with `--SEIDecodedPictureHash=3` (the checksum hash) and no `-o`, the
grid's P recon stays on the card: only `-o` and the MD5/CRC hashes need it
on the host.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main_encode(argv: list[str]) -> int:
    from .codec.encoder import encode_sequence
    from .config.options import build_config, parse_args
    from .utils.yuv import YuvReader, write_yuv

    opts = parse_args(argv)
    device = opts.pop("Device", "cuda")
    cfg, io = build_config(opts)
    if not io["InputFile"] or not io["BitstreamFile"]:
        print("need -i input.yuv and -b out.bin", file=sys.stderr)
        return 2
    cfg.fetch_recon = bool(io["ReconFile"])
    reader = YuvReader(io["InputFile"], cfg.sps.width, cfg.sps.height,
                       cfg.sps.bit_depth)
    t0 = time.time()
    enc, recons = encode_sequence(reader, cfg, device=device)
    total_bits = 0
    psnrs = np.zeros(3)
    for r in enc.results:
        stype = "I" if enc._slice_type(r.poc) == 2 else "P"
        print(
            f"POC {r.poc:4d} ( {stype}-SLICE, QP {enc.frame_qp(r.poc)} ) "
            f"{r.bits:10d} bits [Y {r.psnr_y:.4f} dB  U {r.psnr_u:.4f} dB  "
            f"V {r.psnr_v:.4f} dB] [MD5:{r.md5[0].hex()}]"
        )
        total_bits += r.bits
        psnrs += [r.psnr_y, r.psnr_u, r.psnr_v]
    n = len(enc.results)
    kbps = total_bits * cfg.frame_rate / n / 1000 if n else 0
    print("\nSUMMARY " + "-" * 56)
    print("\tTotal Frames |   Bitrate     Y-PSNR    U-PSNR    V-PSNR")
    print(f"\t{n:12d} a {kbps:12.4f} {psnrs[0]/max(n,1):9.4f} "
          f"{psnrs[1]/max(n,1):9.4f} {psnrs[2]/max(n,1):9.4f}")
    data = enc.bitstream()
    with open(io["BitstreamFile"], "wb") as f:
        f.write(data)
    print(f"\nBytes written to file: {len(data)}"
          f" ({len(data) * 8 * cfg.frame_rate / max(n, 1) / 1000:.3f} kbps)")
    if io["ReconFile"]:
        crop = [(y[: cfg.sps.height, : cfg.sps.width],
                 u[: cfg.sps.height // 2, : cfg.sps.width // 2],
                 v[: cfg.sps.height // 2, : cfg.sps.width // 2])
                for (y, u, v) in recons]
        write_yuv(io["ReconFile"], crop, cfg.sps.bit_depth)
    print(f"\n Total Time: {time.time() - t0:12.3f} sec.")
    return 0


def main_decode(argv: list[str]) -> int:
    from .codec.decoder import decode_stream
    from .utils.yuv import write_yuv

    bit_path = out_path = None
    i = 0
    while i < len(argv):
        if argv[i] == "-b":
            bit_path = argv[i + 1]
            i += 2
        elif argv[i] == "-o":
            out_path = argv[i + 1]
            i += 2
        else:
            raise SystemExit(f"unknown option {argv[i]}")
    if not bit_path:
        print("need -b bitstream", file=sys.stderr)
        return 2
    data = open(bit_path, "rb").read()
    frames = decode_stream(data)
    ok = True
    for f in frames:
        status = "OK" if f.md5_ok else ("unk" if f.md5_ok is None else "***ERROR***")
        print(f"POC {f.poc:4d} [MD5:({status})]")
        ok &= f.md5_ok is not False
    if out_path and frames:
        disp = sorted(frames, key=lambda f: f.poc)
        write_yuv(out_path, [(f.y, f.u, f.v) for f in disp])
    return 0 if ok else 1


def main_extract(argv: list[str]) -> int:
    import argparse

    from .models.fme_data import extract, split_frames, write_csv

    ap = argparse.ArgumentParser(prog="python -m tpuhevc_torch extract")
    ap.add_argument("out")
    ap.add_argument("--input")
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--qp", type=int, default=32)
    a = ap.parse_args(argv)
    w, h = a.width, a.height
    if a.input:
        with open(a.input, "rb") as f:
            raw = f.read(a.frames * w * h * 3 // 2)
    else:
        from tools.make_test_clip import make_clip

        raw = make_clip(w, h, a.frames)
    sads, dims, labels = extract(split_frames(raw, w, h), a.qp)
    write_csv(a.out, sads, dims, labels)
    print(f"{a.out}: {len(labels)} samples, "
          f"{len(np.unique(labels))} distinct classes")
    return 0


def main_train(argv: list[str]) -> int:
    import argparse

    from .models.fme_data import load_csv
    from .models.fme_train import train_fme
    from .models.nnfme import TrainConfig, save_npz

    ap = argparse.ArgumentParser(prog="python -m tpuhevc_torch train")
    ap.add_argument("out")
    ap.add_argument("--data", action="append", required=True,
                    help="csv_path:qp (repeatable)")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--Device", default="cuda")
    a = ap.parse_args(argv)
    per_qp = {}
    for spec in a.data:
        path, qp = spec.rsplit(":", 1)
        sads, heights, widths, labels = load_csv(path)
        t0 = time.time()
        params, acc = train_fme(sads, labels, heights, widths,
                                TrainConfig(epochs=a.epochs, lr=a.lr),
                                device=a.Device)
        per_qp[int(qp)] = params
        print(f"QP {qp}: {len(labels)} samples, val acc {acc:.2%} "
              f"({time.time() - t0:.2f} s on {a.Device})")
    save_npz(a.out, per_qp)
    print(f"wrote {a.out} ({sorted(per_qp)} QPs)")
    return 0


COMMANDS = {"enc": main_encode, "dec": main_decode, "extract": main_extract,
            "train": main_train}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in COMMANDS:
        print(__doc__)
        return 2
    return COMMANDS[sys.argv[1]](sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())

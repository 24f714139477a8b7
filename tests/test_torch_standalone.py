"""tpuhevc_torch stands alone: it imports nothing of the JAX package.

- statically: no file under tpuhevc_torch/, nor chip_smoke.py, imports
  `tpuhevc`, a `tpuhevc.*` module or `jax` (an AST scan of every import
  statement, relative imports resolved against the file's package);
- at run time: in a fresh interpreter whose import system refuses `jax`,
  `tpuhevc` and every `tpuhevc.*` name, the port encodes each of its three
  paths on the CPU at 64x48 (all-intra 1 picture, LD-P 3, random access
  6) from the port's own options, and its own decoder (also through
  `python -m tpuhevc_torch dec`) decodes every picture with the hash OK;
  and the multi-device path (`tpuhevc_torch.parallel.dryrun`) runs on a
  mesh of 2 x cpu; and the NN-FME dataset extraction and training
  (`python -m tpuhevc_torch extract`, then `train --Device=cpu`) write a
  CSV and an npz, with `optax` refused too;
- the port binds the repository's native entropy library itself, and
  raises where it can be neither built nor loaded (no silent slower
  path).
"""

import ast
import os
import subprocess
import sys

import pytest

from tpuhevc_torch.entropy import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tpuhevc_torch")


def sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_modules(path):
    """Absolute names of every module the file imports."""
    tree = ast.parse(open(path).read(), filename=path)
    pkg = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[: len(pkg) - node.level + 1]
                names.append(".".join(base + ([node.module] if node.module
                                              else [])))
            else:
                names.append(node.module)
    return names


def test_no_file_of_the_port_imports_tpuhevc_or_jax():
    files = sources()
    assert len(files) > 40 and os.path.join(PORT, "app.py") in files
    bad = []
    for path in files:
        for name in imported_modules(path):
            top = name.split(".")[0]
            if top in ("tpuhevc", "jax", "jaxlib", "flax", "optax"):
                bad.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert not bad, "\n".join(bad)


BLOCKER = """
import importlib.abc
import sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "optax", "tpuhevc"):
            raise ImportError(f"{name} is refused: the port stands alone")
        return None


sys.meta_path.insert(0, Refuse())
"""

RUN = """
import os, subprocess, sys
import numpy as np
from tools.make_test_clip import make_clip
from tpuhevc_torch.codec.decoder import decode_stream
from tpuhevc_torch.codec.encoder import encode_sequence
from tpuhevc_torch.config.options import build_config, parse_args
from tpuhevc_torch.models.nnfme import random_params, save_npz

W, H = 64, 48
CFG, N, EXTRA = {cfg!r}, {n}, {extra!r}
npz = os.path.join({tmp!r}, "w.npz")
save_npz(npz, {{32: random_params(0)}})
raw = make_clip(W, H, N)
fsz = W * H * 3 // 2
frames = []
for i in range(N):
    b = np.frombuffer(raw[i * fsz : (i + 1) * fsz], np.uint8)
    frames.append((b[: W * H].reshape(H, W),
                   b[W * H : W * H * 5 // 4].reshape(H // 2, W // 2),
                   b[W * H * 5 // 4 :].reshape(H // 2, W // 2)))


class Reader:
    def read_frame(self, i):
        return frames[i] if i < N else None


cfg, _ = build_config(parse_args(
    ["-c", os.path.join({root!r}, "cfg", CFG), "-wdt", str(W), "-hgt",
     str(H), "-f", str(N), "-q", "32", "--NNWeightsDir=" + npz] + EXTRA))
enc, recons = encode_sequence(Reader(), cfg, device="cpu")
stream = enc.bitstream()
decoded = decode_stream(stream)
assert len(decoded) == N, len(decoded)
assert all(f.md5_ok for f in decoded), [f.md5_ok for f in decoded]
for f, (y, u, v) in zip(decoded, recons):
    assert np.array_equal(f.y, y[:H, :W]) and np.array_equal(f.u, u[:H // 2, :W // 2])
bit = os.path.join({tmp!r}, "out.bin")
open(bit, "wb").write(stream)
sys.argv = ["tpuhevc_torch", "dec", "-b", bit]
from tpuhevc_torch.app import main
assert main() == 0
blocked = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "tpuhevc"))
# TMVP is granted in the SPS on the LD-P grid path only
print("tmvp", int(cfg.sps.temporal_mvp_enabled))
print("pocs", [r.poc for r in enc.results], "loaded", blocked)
"""

PATHS = {  # name: (cfg file, pictures, extra options, decode order)
    "all_intra": ("encoder_intra_main.cfg", 1, [], [0]),
    # 64x48 is whole 16x16 blocks: the LD-P grid step, 4 references
    "ldp": ("encoder_lowdelay_P_main.cfg", 3,
            ["--RDOQ=0", "--SignHideFlag=0", "--SAO=0",
             "--LoopFilterDisable=1"], [0, 1, 2]),
    "random_access": ("encoder_randomaccess_main.cfg", 6, [],
                      [0, 4, 2, 1, 3, 5]),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_port_runs_with_tpuhevc_and_jax_refused(tmp_path, path):
    cfg, n, extra, order = PATHS[path]
    code = (f"import sys\nsys.path.insert(0, {ROOT!r})\n" + BLOCKER
            + RUN.format(cfg=cfg, n=n, extra=extra, tmp=str(tmp_path),
                         root=ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path),
                         # one intra-op thread: faster at these sizes
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == f"pocs {order} loaded []", lines[-3:]
    assert lines[-2] == f"tmvp {int(path == 'ldp')}", lines[-3:]
    assert sum("[MD5:(OK)]" in ln for ln in lines) == n


def test_parallel_path_runs_with_tpuhevc_and_jax_refused(tmp_path):
    """The multi-device path (tpuhevc_torch.parallel) on a mesh of 2 x cpu:
    dryrun_multichip's prescreen, stripe refine, sharded frame step and
    segments, with `jax` and `tpuhevc` refused; its unported step raises."""
    code = (f"import sys\nsys.path.insert(0, {ROOT!r})\n" + BLOCKER + """
from tpuhevc_torch.parallel.dryrun import dryrun_multichip, main
assert main(["--devices", "2", "--device", "cpu"]) == 0
for step in ("1",):  # the DP train step
    try:
        dryrun_multichip(2, "cpu", (step,))
        raise SystemExit(f"step {step} ran")
    except NotImplementedError:
        pass
print("loaded", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "tpuhevc")))
""")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path),
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "loaded []", lines
    assert [ln.split(":")[0] for ln in lines[:-1]] == [
        "step 2", "step 2b", "step 2c", "step 3"], lines


def test_training_runs_with_tpuhevc_jax_and_optax_refused(tmp_path):
    """`extract` then `train` through the port's CLI on the CPU (64x48 x
    3, 2 epochs): the CSV and the npz are written, and nothing of jax,
    optax or tpuhevc is loaded."""
    code = (f"import sys\nsys.path.insert(0, {ROOT!r})\n" + BLOCKER + """
import numpy as np
from tpuhevc_torch.app import main_extract, main_train
from tpuhevc_torch.models.nnfme import PARAM_KEYS, load_npz
assert main_extract(["d.csv", "--width", "64", "--height", "48",
                     "--frames", "3"]) == 0
assert main_train(["w.npz", "--data", "d.csv:32", "--epochs", "2",
                   "--Device=cpu"]) == 0
w = load_npz("w.npz")
assert sorted(w) == [32] and sorted(w[32]) == sorted(PARAM_KEYS), w
assert all(np.isfinite(v).all() for v in w[32].values())
print("loaded", sorted(m for m in sys.modules if m.split(".")[0] in
                       ("jax", "jaxlib", "optax", "tpuhevc")))
""")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path),
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "loaded []", lines
    assert lines[0].startswith("d.csv: 24 samples"), lines


def test_native_library_binds_the_committed_file():
    lib = native.get_lib()
    assert lib._name == os.path.join(ROOT, "native", "libtpuhevc_entropy.so")
    assert lib.tpuhevc_encode_slice_data_v5.restype is not None


def test_native_library_that_cannot_be_built_raises(monkeypatch, tmp_path):
    def fail():
        raise subprocess.CalledProcessError(1, ["g++"], stderr=b"no compiler")

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_lib_path",
                        lambda: str(tmp_path / "absent.so"))
    monkeypatch.setattr(native, "_build", fail)
    with pytest.raises(RuntimeError, match="no compiler"):
        native.get_lib()

"""Compare two checkouts' decoder forward on one card, bit for bit and in
time.

    git archive <commit> tpu_diinn_torch | tar -x -C build/first
    python3 -m tpu_diinn_torch.tools.fwd_compare build/first build/second

Runs each tree (a directory holding a ``tpu_diinn_torch/``) in its own
process, in turns (first, second, second, first), on seeded weights and
inputs at hidden 256, L = 4: ``decode_int_fwd`` at smoke phase 3's eval
shapes (LR 64² x4, 32² x8, 128² x4, 64² x8) and phase 3b's training
shapes (B 4, LR 48, x2, x3, x4); ``decode_window_fwd`` at phase 3's
117-column window (LR 82 -> 256, columns 117:234), phase 3b's x2.5 (B 4,
LR 48 -> 120) and the x20 streaming band (LR 256² -> 5120², rows
2560:2592); each in fp32 and bf16. Each run builds its tree's forward
library (cached in the tree) and prints one JSON line: the card's name and
power limit, and per case a SHA-256 of the output, the CUDA-event
milliseconds per call through the wrapper as the smoke times it (the
weight slabs made in the call, ``ms``) and with the slabs made beforehand
(``ms_slabs``), and ``torch.profiler``'s device milliseconds per call of
the decoder kernel alone (``kernel_ms``). The last line says, per case,
whether the two trees' outputs are bit-identical and whether each tree's
two runs agree. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

_RUN = r"""
import hashlib, json, math, subprocess, sys
import numpy as np
import torch
from tpu_diinn_torch.core import grids
from tpu_diinn_torch.kernels import decoder_fused as K
from torch.profiler import ProfilerActivity, profile

label = sys.argv[1]
dev = torch.device("cuda", 0)
gen = torch.Generator().manual_seed(1)
h, n = 256, 4
def u(shape, fan_in):
    return ((torch.rand(shape, generator=gen) * 2 - 1)
            / math.sqrt(fan_in)).to(dev).contiguous()
p32 = {"w0": u((3, h), 3), "b0": u((h,), 3),
       "wcat": u((n - 1, h, 2 * h), h), "bcat": u((n - 1, 2 * h), h),
       "wl": u((h, 3), h), "bl": u((3,), h)}

# (name, B, LR side, integer ratio or HR side, window (r0, r1, c0, c1))
CASES = [("int LR 64 x4", 1, 64, 4, None), ("int LR 32 x8", 1, 32, 8, None),
         ("int LR 128 x4", 1, 128, 4, None), ("int LR 64 x8", 1, 64, 8, None),
         ("int B 4 LR 48 x2", 4, 48, 2, None),
         ("int B 4 LR 48 x3", 4, 48, 3, None),
         ("int B 4 LR 48 x4", 4, 48, 4, None),
         ("window LR 82 -> 256, cols 117:234", 1, 82, 256,
          (0, 256, 117, 234)),
         ("window B 4 LR 48 -> 120", 4, 48, 120, (0, 120, 0, 120)),
         ("window LR 256 -> 5120, rows 2560:2592", 1, 256, 5120,
          (2560, 2592, 0, 5120))]

def call(b, h_in, s, window, dtype):
    zgen = torch.Generator().manual_seed(h_in * 10 + b)
    z = torch.randn((b, h_in, h_in, n * h), generator=zgen).to(dev)
    z = z.to(dtype)
    p = {k: v.to(dtype) if k in K.WEIGHT_KEYS else v for k, v in p32.items()}
    slabs = K.forward_slabs(p["wcat"])
    if window is None:
        h_out = h_in * s
        syn = grids.syn_input_grid((h_in, h_in), (h_out, h_out), dtype=dtype,
                                   device=dev).float()
        return (lambda: K.decode_int_fwd(z, syn, s, s, p),
                lambda: K.decode_int_fwd(z, syn, s, s, p, slabs))
    r0, r1, c0, c1 = window
    idx = grids.nearest_exact_indices(h_in, s)
    rows = K.index_vector(idx[r0:r1], h_in, dev)
    cols = K.index_vector(idx[c0:c1], h_in, dev)
    syn = grids.syn_input_grid((h_in, h_in), (s, s), dtype=dtype,
                               device=dev)[r0:r1, c0:c1].float().contiguous()
    return (lambda: K.decode_window_fwd(z, syn, rows, cols, p),
            lambda: K.decode_window_fwd(z, syn, rows, cols, p, slabs))

def sha(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

def event_ms(fn, reps=20):
    fn(); torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    e.record(); torch.cuda.synchronize()
    return a.elapsed_time(e) / reps

def kernel_ms(fn, reps=5):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0)
        if t and "decode_fwd" in ev.key:
            name = ev.key.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + t / reps / 1e3
    return out

cases = {}
for name, b, h_in, s, window in CASES:
    for dtype in (torch.float32, torch.bfloat16):
        fn, fn_slabs = call(b, h_in, s, window, dtype)
        out = fn()
        torch.cuda.synchronize()
        cases[f"{name} {str(dtype)[6:]}"] = {
            "sha": sha(out), "finite": bool(torch.isfinite(out).all()),
            "ms": event_ms(fn), "ms_slabs": event_ms(fn_slabs),
            "kernel_ms": kernel_ms(fn_slabs)}
        del out, fn, fn_slabs
        torch.cuda.empty_cache()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
print(json.dumps({"tree": label, "card": smi, "cases": cases}), flush=True)
"""


def _run(tree: Path, label: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    out = subprocess.run([sys.executable, "-c", _RUN, label], cwd=tree,
                         env=env, capture_output=True, text=True)
    sys.stderr.write(out.stderr[-4000:])
    if out.returncode:
        raise SystemExit(f"{label}: exit {out.returncode}")
    line = out.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("first", type=Path)
    ap.add_argument("second", type=Path)
    args = ap.parse_args(argv)
    trees = {"first": args.first.resolve(), "second": args.second.resolve()}
    runs = [_run(trees[k], k) for k in ("first", "second", "second",
                                        "first")]
    same = {}
    for case in runs[0]["cases"]:
        h = [r["cases"][case]["sha"] for r in runs]
        same[case] = {"trees_bit_identical": h[0] == h[1],
                      "first_repeats": h[0] == h[3],
                      "second_repeats": h[1] == h[2]}
    print(json.dumps({"compare": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

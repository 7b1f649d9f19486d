"""Compare two checkouts' decoder backward on one card, bit for bit and in
time.

    git archive <commit> tpu_diinn_torch | tar -x -C build/first
    python3 -m tpu_diinn_torch.tools.bwd_compare build/first build/second

Runs each tree (a directory holding a ``tpu_diinn_torch/``) in its own
process, in turns (first, second, second, first), on smoke phase 3b's
training shapes: B 4, LR 48, hidden 256, L = 4, seeded weights and
inputs; ``decode_int_bwd`` at x2, x3, x4 and ``decode_window_bwd`` at
x2.5, in fp32 and bf16. Each run builds its tree's libraries (once: the
build is cached in the tree) and prints one JSON line: the card's name and
power limit, and per case the CUDA-event milliseconds per call,
``torch.profiler``'s device milliseconds per call by kernel, and a SHA-256
of dz and of the flat weight gradients. The last line says, per case,
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
import torch
from tpu_diinn_torch.core import grids
from tpu_diinn_torch.kernels import decoder_fused as K
from torch.profiler import ProfilerActivity, profile

label = sys.argv[1]
dev = torch.device("cuda", 0)
gen = torch.Generator().manual_seed(1)
h, n, b, h_in = 256, 4, 4, 48
def u(shape, fan_in):
    return ((torch.rand(shape, generator=gen) * 2 - 1)
            / math.sqrt(fan_in)).to(dev).contiguous()
p32 = {"w0": u((3, h), 3), "b0": u((h,), 3),
       "wcat": u((n - 1, h, 2 * h), h), "bcat": u((n - 1, 2 * h), h),
       "wl": u((h, 3), h), "bl": u((3,), h)}
z32 = torch.randn((b, h_in, h_in, n * h), generator=gen).to(dev)

def call(scale, dtype):
    h_out = int(h_in * scale)
    z = z32.to(dtype)
    p = {k: v.to(dtype) if k in K.WEIGHT_KEYS else v for k, v in p32.items()}
    syn = grids.syn_input_grid((h_in, h_in), (h_out, h_out), dtype=dtype,
                               device=dev).float()
    g = torch.randn((b, h_out, h_out, 3), generator=torch.Generator()
                    .manual_seed(int(10 * scale))).to(dev)
    if scale == int(scale):
        return lambda: K.decode_int_bwd(z, syn, int(scale), int(scale), p, g)
    idx = K.index_vector(grids.nearest_exact_indices(h_in, h_out), h_in, dev)
    return lambda: K.decode_window_bwd(z, syn, idx, idx, p, g)

def sha(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

def event_ms(fn, reps=10):
    fn(); torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    e.record(); torch.cuda.synchronize()
    return a.elapsed_time(e) / reps

def by_kernel(fn, reps=3):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0)
        if t and "_kernel" in ev.key:
            name = ev.key.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + t / reps / 1e3
    return out

cases = {}
for scale in (2, 3, 4, 2.5):
    for dtype in (torch.float32, torch.bfloat16):
        fn = call(scale, dtype)
        dz, grads = fn()
        flat = torch.cat([grads[k].reshape(-1) for k in K.PARAM_KEYS])
        cases[f"x{scale} {str(dtype)[6:]}"] = {
            "sha_dz": sha(dz), "sha_grads": sha(flat),
            "ms": event_ms(fn), "ms_by_kernel": by_kernel(fn)}
        del dz, grads, flat, fn
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
        h = [(r["cases"][case]["sha_dz"], r["cases"][case]["sha_grads"])
             for r in runs]
        same[case] = {"trees_bit_identical": h[0] == h[1],
                      "first_repeats": h[0] == h[3],
                      "second_repeats": h[1] == h[2]}
    print(json.dumps({"compare": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

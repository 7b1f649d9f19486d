"""Time a checkout's decoder kernels whole and cut short, on one card.

    git archive <commit> tpu_diinn_torch | tar -x -C build/tree
    python3 -m tpu_diinn_torch.tools.chain_split build/tree [--scale 4]
        [--cuts fwd_stores,fwd_only,no_mma,no_refill,no_mma+no_refill]
        [--dtype bfloat16] [--route bwd|fwd]

Runs the tree, and for each cut a copy of ``<tree>/tpu_diinn_torch``
beside it with one piece of its device code taken out:

- ``fwd_stores``: the fp32 backward chain kernel
  (``decode_bwd_chain_kernel`` in ``csrc/decoder_bwd.cuh``) returns after
  its forward recompute, the line before the comment ``// 4) dq = g @
  Wl^T``;
- ``fwd_only``: as ``fwd_stores``, and the recompute's scratch stores of
  q, k and a go too (every line that stores to ``sq``, ``sk`` or ``sa``);
- ``no_mma``: the chain's product loop (``wg_product`` in
  ``csrc/hopper_chain.cuh``) issues no wgmma; its loads and waits stay;
- ``no_refill``: the product loop loads each warpgroup's first ring of
  weight slabs only and reads it again for every k step (no TMA traffic
  after the first slabs);
- ``bf16_fwd_only``, ``bf16_no_layer0``: the bf16 chain kernel
  (``decode_bwd_chain_bf16_kernel``) returns after its forward (before
  its step 3), or before its layer-0 step (step 5);
- ``bf16_no_shuffle``: its column sums skip the warp shuffles
  (``warp_rows_sum`` returns its argument);
- ``bf16_no_dstore``, ``bf16_no_qstore``: it writes no d rows, or no q
  rows, to the scratch;
- ``bf16_no_fold``: it stages no dz terms and folds none;
- ``bf16_plain_stores``: not a cut: its scratch rows go out by plain
  stores, not streaming ones (``store16``).

With ``--route fwd`` the runs time the forward alone, and the cuts are
the bf16 forward's (``--dtype bfloat16``), each made in whichever design
the tree has: ``csrc/decoder_fwd_bf16.cuh``'s kernel where the tree has
that file, else the chain routine that ``decode_fwd_kernel`` runs
(``hopper_chain.cuh``, ``decoder_fused.cuh``; the design before it):

- ``fwd_no_refill``: only the first ring of weight slabs is loaded; every
  later k step reads those slots again (no TMA traffic after them);
- ``fwd_no_mma``: no wgmma is issued; the loads and waits stay;
- ``fwd_no_sine``: the epilogues (layer 0's too) multiply k by a, not
  by sin(a): the polynomial sine goes, the rest of the epilogue stays;
- ``fwd_no_zload``: the epilogues of layers 1..L-1 read no z (each
  element adds 1 in its place): their loads' latency goes;
- ``fwd_no_head``: no head (no output written).

A run may join cuts with ``+``. Each tree runs in its own process (it
builds its own libraries; the cut copies' builds run in parallel first) on
the flagship training shape (B 4, LR 48, hidden 256, L = 4, seeded
weights), in fp32 or (``--dtype bfloat16``) the bf16 instances, and prints
one JSON line: the card's name and power limit, CUDA-event milliseconds
per call of ``decode_int_fwd`` and ``decode_int_bwd`` (route fwd: of
``decode_int_fwd`` as the smoke calls it, the weight slabs made in the
call, and of ``decode_int_fwd_slabs``, the slabs made beforehand), and
``torch.profiler`` device milliseconds per call by kernel; route fwd adds
ptxas's registers and spills of the forward kernels and their HGMMA and
fp32-pipe instruction counts (FFMA, FADD, FMUL, FMNMX, FRND) from
``cuobjdump -sass``. The cut copies compute nothing
usable; they exist only to split the kernels' time. Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

_MARK = "// 4) dq = g @ Wl^T"
_STORE = re.compile(r"store2\((sq|sk|sa)\b")
# the precision policies' product of one k step (``Tf32::mma``,
# ``Bf16::mma``, which only wg_product calls) and wg_product's text, for
# the product cuts
_MMA = re.compile(r"^(\s*)wgmma_(?:tf32|bf16)<kN, (?:kZero|false)>"
                  r"\(d, .*\);$")
_WAIT = """      mbar_wait(bars + slot, (phase >> slot) & 1u);
      phase ^= 1u << slot;
"""
_REFILL = "        if (s + u + kStages < kSteps)"

_RUN = r"""
import json, math, re, shutil, subprocess, sys
import torch
from tpu_diinn_torch.core import grids
from tpu_diinn_torch.kernels import decoder_fused as K
from torch.profiler import ProfilerActivity, profile

scale, variant = int(sys.argv[1]), sys.argv[2]
dtype = getattr(torch, sys.argv[3])
route = sys.argv[4]
dev = torch.device("cuda", 0)
gen = torch.Generator().manual_seed(1)
h, n, b, h_in = 256, 4, 4, 48
def u(shape, fan_in):
    return ((torch.rand(shape, generator=gen) * 2 - 1)
            / math.sqrt(fan_in)).to(dev).contiguous()
p = {"w0": u((3, h), 3), "b0": u((h,), 3), "wcat": u((n - 1, h, 2 * h), h),
     "bcat": u((n - 1, 2 * h), h), "wl": u((h, 3), h), "bl": u((3,), h)}
p = {k: v.to(dtype) if k in K.WEIGHT_KEYS else v for k, v in p.items()}
z = torch.randn((b, h_in, h_in, n * h), generator=gen).to(dev).to(dtype)
h_out = h_in * scale
syn = grids.syn_input_grid((h_in, h_in), (h_out, h_out), device=dev)
g = torch.randn((b, h_out, h_out, 3), generator=gen).to(dev)
calls = {"decode_int_bwd": lambda: K.decode_int_bwd(z, syn, scale, scale,
                                                    p, g),
         "decode_int_fwd": lambda: K.decode_int_fwd(z, syn, scale, scale,
                                                    p)}
info = {}
if route == "fwd":
    slabs = K.forward_slabs(p["wcat"])
    del calls["decode_int_bwd"]
    calls["decode_int_fwd_slabs"] = lambda: K.decode_int_fwd(
        z, syn, scale, scale, p, slabs)
    from tpu_diinn_torch.kernels import build
    build.load("decoder_fused")
    info["ptxas"] = [ln.strip() for ln in build.build_info["decoder_fused"]
                     ["log"].splitlines() if "decode_fwd" in ln
                     or "registers" in ln or "spill" in ln]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass",
                           str(build.library_path("decoder_fused"))],
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HGMMA": 0, "FFMA": 0, "FADD": 0, "FMUL": 0,
                          "FMNMX": 0, "FRND": 0}
        elif fn is not None:
            for op in counts[fn]:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    info["sass_counts"] = counts
def event_ms(fn, reps=10):
    fn(); torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    e.record(); torch.cuda.synchronize()
    return a.elapsed_time(e) / reps
ms = {k: event_ms(fn) for k, fn in calls.items()}
reps = 5
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for fn in calls.values():
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
by_kernel = {}
for ev in prof.key_averages():
    t = getattr(ev, "device_time_total", 0)
    if t and ("decode" in ev.key or "_kernel" in ev.key):
        name = ev.key.split("(")[0].replace("void ", "")
        by_kernel[name] = by_kernel.get(name, 0.0) + t / reps / 1e3
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
print(json.dumps({"variant": variant, "card": smi, "scale": scale,
                  "dtype": sys.argv[3],
                  "shape": f"B {b} LR {h_in}x{h_in} x{scale}",
                  "event_ms": ms, "profiler_ms_by_kernel": by_kernel,
                  **info}), flush=True)
"""


def _cut_bwd(text: str, keep_stores: bool) -> str:
    lines = text.splitlines(keepends=True)
    at = next(i for i, ln in enumerate(lines) if _MARK in ln)
    head = lines[:at]
    if not keep_stores:
        head = [ln for ln in head if not _STORE.search(ln)]
    return "".join(head + ["  return;\n"] + lines[at:])


def _no_mma(text: str) -> str:
    out = [_MMA.sub(r"\1;", ln) for ln in text.split("\n")]
    assert out != text.split("\n"), "no wgmma line found"
    return "\n".join(out)


def _no_refill(text: str) -> str:
    assert _WAIT in text and _REFILL in text, "wg_product changed"
    text = text.replace(_WAIT, "      if (s + u < kStages) {\n" + _WAIT
                        + "      }\n", 1)
    return text.replace(_REFILL, "        if (false)", 1)


def _return_before(mark: str):
    def cut(text: str) -> str:
        assert text.count(mark) == 1, mark
        return text.replace(mark, "  return;\n" + mark, 1)
    return cut


def _drop(*marks: str):
    """Every line holding one of the marks goes (each mark must match)."""
    def cut(text: str) -> str:
        lines = text.split("\n")
        for m in marks:
            assert any(m in ln for ln in lines), m
        return "\n".join(ln for ln in lines if not any(m in ln
                                                       for m in marks))
    return cut


def _replace(old: str, new: str):
    def cut(text: str) -> str:
        assert text.count(old) == 1, old
        return text.replace(old, new)
    return cut


def _no_fold(text: str) -> str:
    text = _drop("store2(fbuf + m * S::kLdF + j, ")(text)
    mark = "      for (int o = tid; o < plan.ppt * kHidden; o += kThreads) {"
    assert text.count(mark) == 1, mark
    return text.replace(mark, "      if (band >= 0) return;\n" + mark)


CUTS = {"fwd_stores": ("decoder_bwd.cuh", lambda t: _cut_bwd(t, True)),
        "fwd_only": ("decoder_bwd.cuh", lambda t: _cut_bwd(t, False)),
        "no_mma": ("hopper_chain.cuh", _no_mma),
        "no_refill": ("hopper_chain.cuh", _no_refill),
        "bf16_fwd_only": ("decoder_bwd.cuh", _return_before(
            "  // 3) dq = g @ Wl^T at the thread's elements (wgmma's")),
        "bf16_no_layer0": ("decoder_bwd.cuh", _return_before(
            "  // 5) layer 0: dpre_0 and dzt_0 with k_0 and a_0")),
        "bf16_no_shuffle": ("decoder_bwd.cuh", _drop(
            "  v += __shfl_xor_sync(0xffffffffu, v, ")),
        "bf16_no_dstore": ("decoder_bwd.cuh", _drop(
            "    copy_rows(sd_layer + row0 * 2 * kHidden, dtile, T::kLdD,",
            "              kTileM);")),
        "bf16_no_qstore": ("decoder_bwd.cuh", _drop(
            "copy_rows(q_row(layer, 0), tile, T::kLdQ, kHidden, kTileM);")),
        "bf16_no_fold": ("decoder_bwd.cuh", _no_fold),
        "bf16_plain_stores": ("decoder_bwd.cuh", _replace(
            "  __stcs(reinterpret_cast<float4*>(p), v);",
            "  *reinterpret_cast<float4*>(p) = v;"))}


# the bf16 forward's cuts: (the new kernel's header and patch, the chain
# routine's header and patch)
_FWD_HEADER = "decoder_fwd_bf16.cuh"
FWD_CUTS = {
    "fwd_no_refill": (
        lambda t: _replace(
            "              mbar_wait_loop(empty + slot, ((n / T::kRing) & 1u) "
            "^ 1u);\n",
            "              if (n >= T::kRing) break;\n"
            "              mbar_wait_loop(empty + slot, ((n / T::kRing) & 1u) "
            "^ 1u);\n")(_replace(
                "            mbar_wait_loop(full + (ns & (T::kRing - 1)),",
                "            if (ns < T::kRing) mbar_wait_loop(full + (ns & "
                "(T::kRing - 1)),")(t)),
        ("hopper_chain.cuh", _no_refill)),
    "fwd_no_mma": (
        _replace("            wgmma_ss<T::kNF>(acc, q + s * 1024,\n"
                 "                             ring + ((n + s) & (T::kRing - "
                 "1)) * T::kSlab);", "            ;"),
        ("hopper_chain.cuh", _no_mma)),
    "fwd_no_sine": (
        lambda t: t.replace("pack_bf16(k0 * poly_sin(a0), k1 * poly_sin(a1))",
                            "pack_bf16(k0 * a0, k1 * a1)"),
        ("hopper_chain.cuh",
         lambda t: t.replace("P::round(k0 * poly_sin(a0))",
                             "P::round(k0 * a0)")
         .replace("P::round(k1 * poly_sin(a1))", "P::round(k1 * a1)"))),
    "fwd_no_zload": (
        _replace("zz[i][hh] = *reinterpret_cast<const uint32_t*>(\n"
                 "                z + zrow[hh] + layer * kHidden + j0 + 8 * i);",
                 "zz[i][hh] = 0x3f803f80u;"),
        ("hopper_chain.cuh", _replace(
            "          zz[i][hh] = P::load_z2(z + zrow[hh] + layer * kHidden "
            "+ j0 +\n                                 8 * i);",
            "          zz[i][hh] = make_float2(1.f, 1.f);"))),
    "fwd_no_head": (
        _replace("      if (qi < n_query) {\n        float acc0",
                 "      if (false) {\n        float acc0"),
        ("decoder_fused.cuh", _replace("  if (tid < kTileM * 3) {",
                                       "  if (false) {"))),
}


def _cut(tree: Path, name: str) -> Path:
    """A copy of the tree with the cuts of ``name`` (joined by ``+``)."""
    out = tree.parent / f"{tree.name}_{name.replace('+', '_')}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(tree / "tpu_diinn_torch", out / "tpu_diinn_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = out / "tpu_diinn_torch" / "csrc"
    for cut in name.split("+"):
        if cut in FWD_CUTS:
            new, (header, patch) = FWD_CUTS[cut]
            if (csrc / _FWD_HEADER).exists():
                header, patch = _FWD_HEADER, new
        else:
            header, patch = CUTS[cut]
        src = csrc / header
        text = src.read_text()
        cut_text = patch(text)
        assert cut_text != text, f"cut {cut} changed nothing in {header}"
        src.write_text(cut_text)
    return out


def _prebuild(roots, libs) -> None:
    """Build every tree's libraries, all at once (one process a tree)."""
    code = ("import sys\nfrom tpu_diinn_torch.kernels import build\n"
            "for name in sys.argv[1:]:\n    build.build(name)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, *libs], cwd=root,
                              env=dict(os.environ, PYTHONPATH=str(root)))
             for root in roots]
    for proc in procs:
        proc.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", type=Path)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--route", default="bwd", choices=("bwd", "fwd"))
    ap.add_argument("--cuts", default="fwd_stores,fwd_only",
                    help="comma-separated runs, each a cut of "
                    + ", ".join(list(CUTS) + list(FWD_CUTS))
                    + " or several joined by +; empty: the tree alone")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    runs = [("full", tree)] + [(c, _cut(tree, c))
                               for c in args.cuts.split(",") if c]
    _prebuild([root for _, root in runs],
              ["decoder_fused"] + (["decoder_bwd"] if args.route == "bwd"
                                   else []))
    rc = 0
    for variant, root in runs:
        env = dict(os.environ, PYTHONPATH=str(root))
        rc |= subprocess.run([sys.executable, "-c", _RUN, str(args.scale),
                              variant, args.dtype, args.route], cwd=root,
                             env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

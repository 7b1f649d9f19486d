"""On-card smoke test of the PyTorch/CUDA port (``tpu_diinn_torch``).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and a checkout of this
repository (it reads ``results/flagship_weights.npz`` and ``data/``).
Phases, each ending in one flushed JSON line with its elapsed seconds:

1. device: ``nvidia-smi`` name and power limit, torch / CUDA versions;
2. build: the CUDA kernel libraries with plain ``nvcc``, one process per
   library, all started together (content-addressed under
   ``build/tpu_diinn_torch/``);
3. kernels: the eval kernels at flagship widths (hidden 256, L = 4, fp32)
   on main-path shapes, held against their plain PyTorch versions (max abs
   error <= 1e-4: fp32 sums in another order over K <= 512), with time,
   plain time and bound;
3b. training kernels at flagship widths and the training shapes (B = 4,
   LR 48x48): ``decode_int_fwd`` and ``decode_int_bwd`` at x2, x3, x4,
   ``decode_window_fwd`` and ``decode_window_bwd`` at 48 -> 120 (x2.5),
   one window over the whole grid. The forwards are held as in phase 3;
   the backward's dz and each weight gradient to max abs error
   <= 1e-4 of the plain version's largest magnitude, with the upstream
   gradient zeroed on the queries whose relu pre-activations come within
   1e-5 of zero (``relu_margin``: there two correct fp32 implementations
   may take different sides of the mask). A second call must agree bit
   for bit (the weight-gradient sum is deterministic);
4. slice, eval: the flagship benchmark evaluation through the benchmark
   CLI's ``main`` (4 sets x scales {3.14, 4, 8}); both forward kernels
   must have been launched, and all 36 metrics must match the committed
   JAX-CPU oracle (|dPSNR|, |dLR-PSNR| <= 2e-3 dB, |dSSIM| <= 1e-4: cuDNN
   and XLA-CPU sum the encoder's convolutions in different orders); CUDA
   events around every decoder call give its device seconds;
5. slice, training, on ``data/DIV2K``:
   a. three flagship steps (``loop.make_train_step``) from
      ``results/flagship_weights.npz`` on the first three batches of epoch
      0, against the committed JAX-CPU oracle: step-1 loss relative
      <= 1e-5; step-1 grad norm relative <= 5e-4, because the L1 loss's
      subgradient sign(pred - hr) flips between two correct fp32
      implementations wherever |pred - hr| is below rounding (the phase's
      step-1 probe counts the residuals under 3e-7, about a hundred of
      801,792 at the trained weights, and reads how far flipping their
      signs moves the norm; it also reads the norm of the eager decoder
      route and of the port's step 1 on the CPU with the plain decoder
      versions, each against the oracle); steps 2-3: losses and grad
      norms relative <= 1e-4;
   b. ``cli.train``'s ``main`` from the seeded init: 20 steps, validation
      on two images, checkpoint; ``decode_int_bwd`` launched exactly 60
      times and ``decode_int_fwd`` at least 60; ``last.npz`` loads back
      into the port's net; steps/s and a per-step split from CUDA events
      (decoder forward and backward kernels, optimizer, the rest of the
      step: encoder forward and backward, loss) and the host's wait for
      the next batch;
   c. ``cli.train``'s ``main`` at scales [2, 2.5]: 5 steps, each launching
      the window kernels once, finite losses;
6. a ``kernels`` JSON line, and last the device JSON line.

Any failure raises and exits non-zero; nothing is caught. Without CUDA it
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tpu_diinn_torch.cli import benchmarks
from tpu_diinn_torch.cli import train as train_cli
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.core import grids
from tpu_diinn_torch.core.fastmath import _SIN_COEFFS
from tpu_diinn_torch.data import pipeline
from tpu_diinn_torch.kernels import build
from tpu_diinn_torch.kernels import decoder_fused as K
from tpu_diinn_torch.nn.registry import make_net
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train.checkpoint import (load_params_npz,
                                              state_dict_from_jax)

ORACLE = "tpu_diinn_torch/testdata/flagship_benchmarks_jax_cpu.json"
TRAIN_ORACLE = "tpu_diinn_torch/testdata/flagship_train_jax_cpu.json"
TPU_LOG = "results/benchmarks_flagship_r5b.log"
WEIGHTS = "results/flagship_weights.npz"
WORK = Path("build/chip_smoke")
SOURCES = {"decode_int_fwd": "tpu_diinn_torch/csrc/decoder_fused.cu",
           "decode_window_fwd": "tpu_diinn_torch/csrc/decoder_fused.cu",
           "decode_int_bwd": "tpu_diinn_torch/csrc/decoder_bwd.cu",
           "decode_window_bwd": "tpu_diinn_torch/csrc/decoder_bwd.cu"}
_PALLAS = "tpu_diinn/kernels/decoder_fused.py"
REPLACES = {"decode_int_fwd": f"{_PALLAS}:732; {_PALLAS}:280",
            "decode_window_fwd": f"{_PALLAS}:236",
            "decode_int_bwd": f"{_PALLAS}:618",
            "decode_window_bwd": f"{_PALLAS}:571"}
FWD = ("decode_int_fwd", "decode_window_fwd")
BWD = ("decode_int_bwd", "decode_window_bwd")
KERNEL_TOL = 1e-4          # forward: max abs error
BWD_TOL = 1e-4             # backward: max abs error / largest magnitude
MARGIN = 1e-5              # relu pre-activation margin (phase 3b)
LOSS_TOL_1, NORM_TOL_1 = 1e-5, 5e-4   # phase 5a, step 1 (relative)
STEP_TOL = 1e-4                       # phase 5a, steps 2-3 (relative)
PSNR_TOL, SSIM_TOL = 2e-3, 1e-4
N_METRICS = 36             # 4 sets x 3 scales x PSNR/SSIM/LR-PSNR
HIDDEN, LAYERS = 256, 4
TRAIN_STEPS, FRACTIONAL_STEPS = 20, 5


def phase(label: str, t_start: float, **fields) -> None:
    line = {"phase": label,
            "seconds": round(time.perf_counter() - t_start, 3), **fields}
    print(json.dumps(line), flush=True)


def card_peaks(name: str) -> tuple:
    """(fp32 non-tensor FLOP/s, HBM bytes/s, which SKU) from NVIDIA's data
    sheets, dense rates at the full power limit."""
    if "PCIe" in name:
        return 51.2e12, 2.0e12, "H100 PCIe: 51.2 TFLOP/s fp32, 2.0 TB/s"
    return 67.0e12, 3.35e12, "H100 SXM: 67 TFLOP/s fp32, 3.35 TB/s"


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def span_seconds(spans) -> float:
    return sum(a.elapsed_time(b) for a, b in spans) / 1e3


@contextlib.contextmanager
def patched(obj, name: str, wrap):
    """``obj.name`` replaced by ``wrap(obj.name)`` for the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def span_recorder(spans: list, active=lambda: True):
    """A wrapper that records a pair of CUDA events around each call on the
    current stream (while ``active()``). A span holds the kernel and any
    stream idle time while the wrapper prepares the launch."""
    def wrap(fn):
        def call(*args, **kwargs):
            if not active():
                return fn(*args, **kwargs)
            a, b = events()
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            spans.append((a, b))
            return out
        return call
    return wrap


def flagship_params(gen: torch.Generator, dev) -> dict:
    """Seeded decoder weights in the kernels' layout, torch-default scale."""
    h, n = HIDDEN, LAYERS

    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=gen) * 2 - 1) * b

    p = {"w0": u((3, h), 3), "b0": u((h,), 3),
         "wcat": u((n - 1, h, 2 * h), h), "bcat": u((n - 1, 2 * h), h),
         "wl": u((h, 3), h), "bl": u((3,), h)}
    return {k: v.to(dev).contiguous() for k, v in p.items()}


def query_flop(hidden: int, n_layers: int) -> int:
    """Matmul FLOP of one query's chain (2 per multiply-add): 789,504 at
    hidden 256, L = 4. Elementwise work (relu, sine, products; ~2.6% more)
    is left out, so the bound stays a lower bound."""
    return 2 * (3 * hidden + (n_layers - 1) * hidden * 2 * hidden
                + hidden * 3)


def query_flop_bwd(hidden: int, n_layers: int) -> int:
    """Matmul FLOP of one query's backward: the recomputed forward plus,
    per product, the dq product and the weight-gradient product of the
    same size: 789,504 + 1,577,472 = 2,366,976 at hidden 256, L = 4."""
    return 3 * query_flop(hidden, n_layers)


def bound(flop: float, nbytes: float, peaks) -> dict:
    t_ops = flop / peaks[0] * 1e3
    t_bytes = nbytes / peaks[1] * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_fwd(name, fn, ref, n_query, nbytes, peaks, shape,
              reps=20) -> dict:
    out = fn()
    torch.cuda.synchronize()
    want = ref()
    err = (out - want).abs().max().item()
    if not (math.isfinite(err) and err <= KERNEL_TOL):
        raise AssertionError(f"{name} {shape}: max abs error {err} > "
                             f"{KERNEL_TOL}")
    del out, want
    ms = time_ms(fn, reps)
    plain_ms = time_ms(ref, 3)
    flop = n_query * query_flop(HIDDEN, LAYERS)
    return {"name": name, "shape": shape, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **bound(flop, nbytes, peaks),
            "library_ms": None, "achieved_tflops": flop / ms / 1e9}


def check_bwd(name, fn, ref, n_query, nbytes, peaks, shape, masked,
              reps=5) -> dict:
    dz, grads = fn()
    torch.cuda.synchronize()
    dz_ref, grads_ref = ref()
    errs, rel = {}, {}
    for key, got, want in [("dz", dz, dz_ref)] + [
            (k, grads[k], grads_ref[k]) for k in K.PARAM_KEYS]:
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        errs[key], rel[key] = err, err / scale
        if not (math.isfinite(err) and err <= BWD_TOL * scale):
            raise AssertionError(f"{name} {shape} {key}: max abs error "
                                 f"{err} > {BWD_TOL} x {scale}")
    if grads["bcat"][:, :HIDDEN].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: the kq half of dbcat is not zero")
    dz2, grads2 = fn()
    deterministic = bool(torch.equal(dz, dz2) and all(
        torch.equal(grads[k], grads2[k]) for k in K.PARAM_KEYS))
    if not deterministic:
        raise AssertionError(f"{name} {shape}: two calls differ")
    del dz, grads, dz_ref, grads_ref, dz2, grads2
    ms = time_ms(fn, reps)
    plain_ms = time_ms(ref, 2)
    flop = n_query * query_flop_bwd(HIDDEN, LAYERS)
    return {"name": name, "shape": shape, "max_abs_err": max(errs.values()),
            "max_rel_err": rel, "masked_queries": masked,
            "deterministic": deterministic, "ms": ms, "plain_ms": plain_ms,
            **bound(flop, nbytes, peaks), "library_ms": None,
            "achieved_tflops": flop / ms / 1e9,
            "ms_by_device_kernel": profile_ms(fn)}


def profile_ms(fn, reps: int = 3) -> dict:
    """Device milliseconds per call of ``fn`` by kernel name, from
    ``torch.profiler`` (the passes inside one backward launch)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t and "decoder" in e.key:
            name = e.key.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + t / reps / 1e3
    return out


def eval_kernels(dev, peaks, t) -> dict:
    """Phase 3: the eval shapes of rows 1 and 2."""
    gen = torch.Generator().manual_seed(0)
    p = flagship_params(gen, dev)
    w_bytes = sum(v.numel() * 4 for v in p.values())
    c_all = HIDDEN * LAYERS
    checks = {}
    for h_in, s in ((64, 4), (32, 8)):
        z = torch.randn((1, h_in, h_in, c_all), generator=gen).to(dev)
        syn = grids.syn_input_grid((h_in, h_in), (h_in * s, h_in * s),
                                   device=dev)
        nq = (h_in * s) ** 2
        res = check_fwd(
            "decode_int_fwd",
            lambda: K.decode_int_fwd(z, syn, s, s, p),
            lambda: K.decode_int_fwd_ref(z, syn, s, s, p), nq,
            z.numel() * 4 + syn.numel() * 4 + w_bytes + nq * 12, peaks,
            f"LR {h_in}x{h_in} x{s}")
        phase("kernel", t, **res)
        checks.setdefault("decode_int_fwd", []).append(res)
    # x3.14 on a 256x256 image: LR 82x82, chunks of 30000 // 256 = 117
    # columns (the second chunk, as the chunked eval decodes it)
    h_in, h_out, lo, hi = 82, 256, 117, 234
    z = torch.randn((1, h_in, h_in, c_all), generator=gen).to(dev)
    rows = grids.nearest_exact_indices(h_in, h_out)
    cols = grids.nearest_exact_indices(h_in, h_out)[lo:hi]
    syn = grids.syn_input_grid((h_in, h_in), (h_out, h_out),
                               device=dev)[:, lo:hi].contiguous()
    nq = rows.size * cols.size
    touched = np.unique(rows).size * np.unique(cols).size * c_all * 4
    rows_v = K.index_vector(rows, h_in, dev)
    cols_v = K.index_vector(cols, h_in, dev)
    res = check_fwd(
        "decode_window_fwd",
        lambda: K.decode_window_fwd(z, syn, rows_v, cols_v, p),
        lambda: K.decode_window_fwd_ref(z, syn, rows, cols, p), nq,
        touched + syn.numel() * 4 + w_bytes + nq * 12
        + (rows.size + cols.size) * 4,
        peaks, f"LR {h_in}x{h_in} -> {h_out}x{h_out}, columns {lo}:{hi}")
    phase("kernel", t, **res)
    checks["decode_window_fwd"] = [res]
    return checks


def train_kernels(dev, peaks, t, checks: dict) -> None:
    """Phase 3b: rows 3-5 at the flagship training shapes."""
    gen = torch.Generator().manual_seed(1)
    p = flagship_params(gen, dev)
    w_bytes = sum(v.numel() * 4 for v in p.values())
    b, h_in = 4, 48
    z = torch.randn((b, h_in, h_in, HIDDEN * LAYERS), generator=gen).to(dev)
    z_bytes = z.numel() * 4
    for s in (2, 3, 4):
        h_out = h_in * s
        syn = grids.syn_input_grid((h_in, h_in), (h_out, h_out), device=dev)
        nq = b * h_out * h_out
        res = check_fwd(
            "decode_int_fwd",
            lambda: K.decode_int_fwd(z, syn, s, s, p),
            lambda: K.decode_int_fwd_ref(z, syn, s, s, p), nq,
            z_bytes + syn.numel() * 4 + w_bytes + nq * 12, peaks,
            f"train B {b} LR {h_in}x{h_in} x{s}", reps=10)
        phase("train_kernel", t, **res)
        checks.setdefault("decode_int_fwd_train", []).append(res)
        rows = np.arange(h_out) // s
        g, masked = masked_grad(z, syn, rows, rows, p, gen)
        res = check_bwd(
            "decode_int_bwd",
            lambda: K.decode_int_bwd(z, syn, s, s, p, g),
            lambda: K.decode_int_bwd_ref(z, syn, s, s, p, g), nq,
            2 * z_bytes + syn.numel() * 4 + 2 * w_bytes + nq * 12, peaks,
            f"train B {b} LR {h_in}x{h_in} x{s}", masked)
        phase("train_kernel", t, **res)
        checks.setdefault("decode_int_bwd", []).append(res)
        del syn, g
    # x2.5: LR 48 -> HR 120, one window over the whole grid
    h_out = 120
    rows = grids.nearest_exact_indices(h_in, h_out)
    syn = grids.syn_input_grid((h_in, h_in), (h_out, h_out), device=dev)
    nq = b * h_out * h_out
    rows_v = K.index_vector(rows, h_in, dev)
    shape = f"train B {b} LR {h_in}x{h_in} -> {h_out}x{h_out} (x2.5)"
    res = check_fwd(
        "decode_window_fwd",
        lambda: K.decode_window_fwd(z, syn, rows_v, rows_v, p),
        lambda: K.decode_window_fwd_ref(z, syn, rows, rows, p), nq,
        z_bytes + syn.numel() * 4 + w_bytes + nq * 12 + 2 * rows.size * 4,
        peaks, shape, reps=10)
    phase("train_kernel", t, **res)
    checks["decode_window_fwd_train"] = [res]
    g, masked = masked_grad(z, syn, rows, rows, p, gen)
    res = check_bwd(
        "decode_window_bwd",
        lambda: K.decode_window_bwd(z, syn, rows_v, rows_v, p, g),
        lambda: K.decode_window_bwd_ref(z, syn, rows, rows, p, g), nq,
        2 * z_bytes + syn.numel() * 4 + 2 * w_bytes + nq * 12
        + 2 * rows.size * 4, peaks, shape, masked)
    phase("train_kernel", t, **res)
    checks["decode_window_bwd"] = [res]


def relu_margin(z: torch.Tensor, syn: torch.Tensor, rows, cols,
                params: dict) -> torch.Tensor:
    """Per query (B, len(rows), len(cols)), the smallest |pre-activation|
    of the relus of layers 1..L-1, from the chain in float64.

    The backward masks by ``k > 0``. Where a pre-activation lies within
    rounding distance of zero, two correct fp32 implementations that sum in
    different orders take different sides, and that query's gradient
    differs by a whole term. A comparison of two backward implementations
    therefore zeroes the upstream gradient of the queries whose margin is
    below its tolerance (layer 0's mask reads z itself and is exact)."""
    f64 = torch.float64
    b = z.shape[0]
    h = params["w0"].shape[1]
    n_layers = params["wcat"].shape[0] + 1
    r = torch.as_tensor(rows, device=z.device).long()
    c = torch.as_tensor(cols, device=z.device).long()
    zt = z[:, r][:, :, c]
    hq, wq = zt.shape[1], zt.shape[2]
    zt = zt.reshape(-1, zt.shape[-1]).to(f64)
    syn64 = syn.to(f64).expand(b, hq, wq, 3).reshape(-1, 3)
    p = {k: v.detach().to(f64) for k, v in params.items()}

    def sin(x):     # the polynomial sine of core/fastmath, in float64
        y = x - torch.round(x / (2 * math.pi)) * (2 * math.pi)
        acc = torch.full_like(y, _SIN_COEFFS[-1])
        for coeff in _SIN_COEFFS[-2::-1]:
            acc = acc * y * y + coeff
        return y * acc

    q = torch.relu(zt[:, :h]) * sin(syn64 @ p["w0"] + p["b0"])
    margin = torch.full((zt.shape[0],), float("inf"), dtype=f64,
                        device=z.device)
    for i in range(1, n_layers):
        both = q @ p["wcat"][i - 1]
        pre = both[:, :h] + zt[:, i * h:(i + 1) * h]
        margin = torch.minimum(margin, pre.abs().amin(dim=1))
        q = torch.relu(pre) * sin(both[:, h:] + p["bcat"][i - 1, h:])
    return margin.reshape(b, hq, wq)


def masked_grad(z, syn, rows, cols, p, gen):
    """A seeded upstream gradient, zero on the queries within MARGIN of a
    relu's switch point; and how many queries that zeroes."""
    keep = relu_margin(z, syn, rows, cols, p) > MARGIN
    g = torch.randn((*keep.shape, 3), generator=gen).to(z.device)
    return (g * keep[..., None]).contiguous(), int((~keep).sum().item())


def eval_slice(t) -> dict:
    """Phase 4: the flagship benchmark evaluation; returns its launches."""
    spans = {name: [] for name in FWD}
    K.reset_launches()
    with contextlib.ExitStack() as stack:
        for name in FWD:
            stack.enter_context(patched(K, name, span_recorder(spans[name])))
        results = benchmarks.main(["--ckpt_path", WEIGHTS, "--device",
                                   "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(K.launches)
    for name in FWD:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on the "
                                 f"benchmark run: {counts}")
    with open(ORACLE) as f:
        oracle = json.load(f)
    deltas = {}
    for set_name, metrics in oracle.items():
        for key, want in metrics.items():
            got = results[set_name][key]
            tol = SSIM_TOL if "ssim" in key else PSNR_TOL
            d = abs(got - want)
            if not (math.isfinite(got) and d <= tol):
                raise AssertionError(f"{set_name} {key}: {got} vs oracle "
                                     f"{want} (|d| {d} > {tol})")
            deltas[f"{set_name}/{key}"] = d
    if len(deltas) != N_METRICS:
        raise AssertionError(f"expected {N_METRICS} metrics, compared "
                             f"{len(deltas)}")
    worst = max(deltas, key=deltas.get)
    with open(TPU_LOG) as f:
        tpu = json.loads([ln for ln in f if ln.strip()][-1])
    tpu_d = max(abs(results[s][k] - v) for s, m in tpu.items()
                if s in results for k, v in m.items())
    phase("slice_eval", t, wall_seconds=round(wall, 3), launches=counts,
          decoder_call_seconds={n: span_seconds(v)
                                for n, v in spans.items()},
          metrics=len(deltas), max_delta_vs_oracle=deltas[worst],
          max_delta_at=worst, max_delta_vs_tpu_v5e_log_info_only=tpu_d)
    return counts


def train_parity(dev, t) -> dict:
    """Phase 5a: three flagship steps from the committed weights against
    the JAX-CPU oracle."""
    cfg = load_config(None, [])
    train_ds, _ = loop.make_datasets(cfg)
    it = pipeline.train_batches(
        train_ds, batch_size=cfg.data.batch_size, epoch=0, seed=cfg.seed,
        repeat=cfg.data.trainsets_repeat, num_workers=cfg.data.num_workers)
    with open(TRAIN_ORACLE) as f:
        want = json.load(f)["steps"]
    batches = [next(it) for _ in range(len(want))]
    it.close()
    flat, _ = load_params_npz(WEIGHTS)
    spe = len(train_ds) * cfg.data.trainsets_repeat // cfg.data.batch_size
    state = loop.init_state(cfg, spe, device=dev, params=flat)
    step = loop.make_train_step(state)
    K.reset_launches()
    got = []
    for batch in batches:
        m = step(loop.to_device(batch, dev))
        got.append({k: float(v) for k, v in m.items()})
    counts = dict(K.launches)
    rel = []
    for i, (g, w) in enumerate(zip(got, want)):
        r_loss = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        r_norm = abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
        tol_loss, tol_norm = ((LOSS_TOL_1, NORM_TOL_1) if i == 0
                              else (STEP_TOL, STEP_TOL))
        if not (r_loss <= tol_loss and r_norm <= tol_norm):
            raise AssertionError(f"step {i + 1}: port {g} vs JAX {w} "
                                 f"(relative {r_loss}, {r_norm})")
        rel.append({"loss": r_loss, "grad_norm": r_norm})
    if counts["decode_int_bwd"] != 3 * len(want):
        raise AssertionError(f"decode_int_bwd launches {counts}")
    del state, step
    probe = step1_probe(cfg, spe, dev, flat, batches[0])
    phase("slice_train_parity", t, steps=got, oracle=want, relative=rel,
          launches=counts, step1_probe=probe,
          step1_probe_relative_to_jax={
              k: abs(v - want[0][m]) / want[0][m]
              for k, v in probe.items() for m in ("loss", "grad_norm")
              if k.endswith(m)})
    return counts


def step1_probe(cfg, spe, dev, flat, host_batch) -> dict:
    """What moves the step-1 gradient norm at the trained weights: the
    eager decoder route (cuBLAS, no custom kernel) in place of the fused
    one, and the fused route with the L1 subgradient sign(pred - hr)
    flipped wherever |pred - hr| < 3e-7, about the rounding of two fp32
    implementations, with the count of such residuals (no update applied);
    and the port's step 1 on the CPU (plain decoder versions, no card
    library). Extra passes, after the launches were read."""
    from tpu_diinn_torch.train.task import normalize
    cpu_state = loop.init_state(cfg, spe, device="cpu", params=flat)
    cpu = loop.make_train_step(cpu_state)(loop.to_device(host_batch, "cpu"))
    del cpu_state
    batch = loop.to_device(host_batch, dev)
    state = loop.init_state(cfg, spe, device=dev, params=flat)
    net, params = state.task.net, list(state.task.net.parameters())

    def grad_norm(flip_below=None):
        net.zero_grad(set_to_none=True)
        items = list(batch.items())
        feats = state.task._shared_lr_features(items)
        loss, counts = 0.0, 0
        for i, (scale, (lr, hr)) in enumerate(items):
            b = lr.shape[0]
            r = net.decoder(feats[i * b:(i + 1) * b],
                            (hr.shape[1], hr.shape[2])) - normalize(hr)
            sign = torch.sign(r.detach())
            near = r.detach().abs() < (flip_below or 0.0)
            counts += int(near.sum())
            loss = loss + (torch.where(near, -sign, sign) * r).mean()
        (loss / len(items)).backward()
        norm = torch.stack([p.grad.square().sum() for p in params])
        return float(norm.sum().sqrt()), counts

    fused, _ = grad_norm()
    flipped, n_near = grad_norm(3e-7)
    net.decoder.use_fused = False
    eager, _ = grad_norm()
    return {"fused_grad_norm": fused, "eager_grad_norm": eager,
            "flipped_grad_norm": flipped, "residuals_below_3e-7": n_near,
            "cpu_loss": float(cpu["loss"]),
            "cpu_grad_norm": float(cpu["grad_norm"])}


def run_train_cli(args: list, tag: str):
    """``cli.train.main`` with its checkpoints and log under WORK/tag."""
    out = WORK / tag
    shutil.rmtree(out, ignore_errors=True)
    state = train_cli.main(["--device", "cuda", *args,
                            f"trainer.ckpt_dir={out}",
                            f"trainer.log_dir={out}"])
    records = [json.loads(ln) for ln in
               (out / "metrics.jsonl").read_text().splitlines()] \
        if (out / "metrics.jsonl").exists() else []
    return state, out, records


def train_slice(t) -> dict:
    """Phase 5b: the flagship trainer from the seeded init, with a
    per-step split read from CUDA events."""
    spans = {k: [] for k in ("step", "fwd", "bwd", "optimizer")}
    host_gaps, in_step, last_exit = [], [False], [None]

    def timed_step(make):
        def make_timed(state):
            step = make(state)

            def call(batch):
                now = time.perf_counter()
                if last_exit[0] is not None:
                    host_gaps.append(now - last_exit[0])
                a, b = events()
                a.record()
                in_step[0] = True
                out = step(batch)
                in_step[0] = False
                b.record()
                spans["step"].append((a, b))
                last_exit[0] = time.perf_counter()
                return out
            return call
        return make_timed

    active = lambda: in_step[0]  # noqa: E731
    K.reset_launches()
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(loop, "make_train_step", timed_step))
        stack.enter_context(patched(loop, "apply_update",
                                    span_recorder(spans["optimizer"])))
        for name in FWD:
            stack.enter_context(patched(K, name, span_recorder(
                spans["fwd"], active)))
        for name in BWD:
            stack.enter_context(patched(K, name, span_recorder(
                spans["bwd"], active)))
        state, out, records = run_train_cli(
            ["--max-steps", str(TRAIN_STEPS), "trainer.limit_val_images=2"],
            "train")
    torch.cuda.synchronize()
    counts = dict(K.launches)
    n = TRAIN_STEPS
    if counts["decode_int_bwd"] != 3 * n or counts["decode_int_fwd"] < 3 * n:
        raise AssertionError(f"launches over {n} steps: {counts}")
    val = records[-1]
    if not (state.step == n and math.isfinite(val["train_loss"])
            and math.isfinite(val["val_loss"])):
        raise AssertionError(f"training record {val}")
    flat, meta = load_params_npz(str(out / "last.npz"))
    net = make_net("diinn")
    net.load_state_dict(state_dict_from_jax(flat), strict=True)
    if meta["step"] != n:
        raise AssertionError(f"last.npz meta {meta}")
    # per-step split over steps 2..n (step 1 warms up cuDNN and the
    # allocator); the decoder spans are 6 per step (3 scales x fwd, bwd)
    per = {k: [a.elapsed_time(b) for a, b in v] for k, v in spans.items()}
    steady = slice(1, None)
    step_ms = float(np.mean(per["step"][steady]))
    fwd_ms = float(np.sum(per["fwd"][3:]) / (n - 1))
    bwd_ms = float(np.sum(per["bwd"][3:]) / (n - 1))
    opt_ms = float(np.mean(per["optimizer"][steady]))
    phase("slice_train", t, steps=state.step, launches=counts,
          train_loss=val["train_loss"], val_loss=val["val_loss"],
          val_psnr={k: v for k, v in val.items() if k.startswith("val_psnr")},
          steps_per_s=val["steps_per_s"], checkpoint=str(out / "last.npz"),
          split_ms_per_step={
              "step": step_ms, "decoder_fwd_kernels": fwd_ms,
              "decoder_bwd_kernels": bwd_ms, "optimizer": opt_ms,
              "encoder_fwd_bwd_and_rest": step_ms - fwd_ms - bwd_ms - opt_ms,
              "host_wait_for_batch": float(np.mean(host_gaps[1:])) * 1e3},
          step_ms_all=per["step"])
    return counts


def train_fractional(t) -> dict:
    """Phase 5c: scales [2, 2.5] through the window kernels."""
    K.reset_launches()
    state, _, records = run_train_cli(
        ["--max-steps", str(FRACTIONAL_STEPS), "data.train_scales=[2,2.5]",
         "trainer.log_every_n_steps=1",
         "trainer.check_val_every_n_epoch=1000"], "fractional")
    torch.cuda.synchronize()
    counts = dict(K.launches)
    n = FRACTIONAL_STEPS
    want = {name: n for name in K.launches}
    if counts != want:
        raise AssertionError(f"launches over {n} steps: {counts}, "
                             f"expected {want}")
    losses = [r["train_loss"] for r in records]
    if not (state.step == n and len(losses) == n
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{state.step} steps, losses {losses}")
    phase("slice_train_fractional", t, steps=state.step, launches=counts,
          train_loss=losses)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", flush=True)
        return 2

    # 1) device
    t = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    phase("device", t, nvidia_smi=smi, kind=kind,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          peaks=peaks[2])
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2) build: one nvcc per library, started together
    t = time.perf_counter()
    build.load_all()
    for name, info in build.build_info.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        phase("build", t, library=name,
              nvcc_seconds=round(info["seconds"], 3),
              path=str(build.library_path(name)), ptxas=regs)

    # 3) and 3b) kernels against their plain versions
    t = time.perf_counter()
    checks = eval_kernels(dev, peaks, t)
    t = time.perf_counter()
    train_kernels(dev, peaks, t, checks)
    torch.cuda.empty_cache()

    # 4) and 5) the main paths, each with the launch counts set to 0 just
    # before it and read just after
    by_path = {}
    by_path["eval"] = eval_slice(time.perf_counter())
    by_path["train_parity"] = train_parity(dev, time.perf_counter())
    by_path["train"] = train_slice(time.perf_counter())
    by_path["train_fractional"] = train_fractional(time.perf_counter())

    # 6) kernels line, then the device line
    kernels = []
    for name in K.launches:
        rs = checks[name]
        first = rs[0]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in
                               rs + checks.get(f"{name}_train", [])),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "shape": first["shape"],
            "achieved_tflops": first["achieved_tflops"]}
        if name in FWD:
            entry["train_shapes"] = [
                {k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "achieved_tflops",
                                   "max_abs_err")}
                for r in checks[f"{name}_train"]]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

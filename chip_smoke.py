"""On-card smoke test of the PyTorch/CUDA port (``tpu_diinn_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --bf16-cpu-witness PATH   # phase 5d's witness

Needs one CUDA card, the CUDA toolkit (``nvcc``) and a checkout of this
repository (it reads ``results/{flagship,liif,metasr}_weights.npz``,
``data/`` and the JAX-CPU oracles under ``tpu_diinn_torch/testdata/``).
Phases, each ending in one flushed JSON line with its elapsed seconds:

1. device: ``nvidia-smi`` name and power limit, torch / CUDA versions;
2. build: the CUDA kernel libraries with plain ``nvcc``, one process per
   library, all started together (content-addressed under
   ``build/tpu_diinn_torch/``), with ``ptxas`` registers and spills and,
   from ``cuobjdump -sass``, each kernel's count of tensor-core (``HMMA``,
   ``HGMMA``) and fp32 ``FFMA`` instructions; every instance of the
   forward kernels (``decode_fwd_kernel``, fp32, and the bf16 mode's own
   ``decode_fwd_bf16_kernel``) must show ``HGMMA``, and the backward's
   chain and weight-gradient kernels tensor-core instructions; every bf16
   instance of them (``<...,Bf16>`` or a ``_bf16_kernel``) must show
   ``HGMMA``;
3. kernels: the eval kernels at flagship widths (hidden 256, L = 4, fp32)
   on main-path shapes (``decode_window_fwd`` also at the x20 streaming
   band: LR 256x256, one 32x5120 band; both also at the bucketed eval's
   padded canvases, phase 10: ``decode_int_fwd`` over LR 128² x4 and 64²
   x8, ``decode_window_fwd``'s first row band over 128² -> 256² and 192²
   -> 512²), held against their plain PyTorch
   versions (max abs
   error <= 1e-4: fp32-level sums in another order over K <= 512; the
   products run in 3xTF32 on the tensor cores), a second call bit for bit
   equal to the first, with time (the wrapper's: the weights' split
   included), device time by kernel, plain time and two bounds, each
   against the bytes at the HBM rate: ``bound_ms`` with the products as
   every kernel runs them, on the tensor cores in 3xTF32 (three TF32
   products per fp32-accurate product), and ``bound_ffma_ms`` with them
   at the fp32 FFMA rate, for reference;
3b. training kernels at flagship widths and the training shapes (B = 4,
   LR 48x48): ``decode_int_fwd`` and ``decode_int_bwd`` at x2, x3, x4,
   ``decode_window_fwd`` and ``decode_window_bwd`` at 48 -> 120 (x2.5),
   one window over the whole grid. The forwards are held as in phase 3;
   the backward's dz and each weight gradient to max abs error
   <= 1e-4 of the plain version's largest magnitude, with the upstream
   gradient zeroed on the queries whose relu pre-activations come within
   1e-5 of zero (``relu_margin``: there two correct fp32 implementations
   may take different sides of the mask). The backward's products run in
   3xTF32 on the tensor cores, which keeps this fp32 tolerance. A second
   call must agree bit for bit (the weight-gradient sum is deterministic).
   Phases 3 and 3b hold each kernel's bf16 instance too, at the fp32 rows'
   shapes, on z and the weights rounded to bf16 (the syn grid built in
   bf16), against its plain bf16 version: the forwards to max abs error
   <= 2e-3 (the outputs are about 0.1; both round q to bf16 after fp32
   sums in different orders, and a q element that rounds to the other
   neighbour moves an output by about 6e-5), the backwards to 1e-2 of the
   largest magnitude with the upstream gradient zeroed within 1e-3 of a
   relu's switch point of the bf16 chain; and each output's error against
   the fp32 chain on the same inputs to at most 1.5x the plain bf16
   version's (+ 1e-5 of the largest magnitude); with ``bound_ms`` at the
   bf16 tensor-core peak;
4. slice, eval: the flagship benchmark evaluation through the benchmark
   CLI's ``main`` on the exact-shape route (``--eval_buckets 0``, as
   phases 4b and 6a; phase 10 runs the CLI's default, bucketed route)
   (4 sets x scales {3.14, 4, 8}); both forward kernels
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
4b. slice, eval in bf16: Set5 at {3.14, 4, 8} through the benchmark CLI
   with ``model.dtype=bfloat16``; both forward kernels launched in bf16
   and no fp32 instance; the 9 metrics against the committed JAX-CPU bf16
   oracle's fused route (Pallas interpret mode), each within the larger of
   twice the gap between JAX's two bf16 routes (XLA and fused) on that
   metric and phase 4's fp32 tolerance;
5d. slice, training in bf16: three flagship steps from the committed
   weights against the bf16 oracle's fused route, each reading within the
   larger of phase 5a's fp32 bound and twice its largest gap to the
   oracle among its witnesses: the port's own three steps on the CPU
   (plain decoder versions, the kernels' rounding points; committed,
   made by ``python3 chip_smoke.py --bf16-cpu-witness PATH``), and for
   the step-1 loss, which only the forward sets, JAX's XLA route too; then ``cli.train``'s ``main`` with ``model.dtype=bfloat16``
   for 20 steps, ``decode_int_bwd`` launched 60 times in bf16 and no fp32
   instance, with 5b's split; and a ``torch.profiler`` read of 5 bf16
   steps: device time by kernel group and the device's idle share;
5e. ``cli.train``'s ``main`` in bf16 at scales [2, 2.5]: 5 steps, every
   bf16 instance launched 5 times, no fp32 instance;
5f. the bench: ``python -m tpu_diinn_torch.bench``'s JSON line, printed on
   a line of its own;
6. the other model families, fp32, each path with the launch counts set
   to 0 before it and read after it:
   a. the benchmark evaluation (4 sets x {3.14, 4, 8}) through the CLI's
      ``main`` of LIIF and MetaSR on ``results/{liif,metasr}_weights.npz``
      and of the bicubic baseline (``--bicubic_test``), all 36 metrics
      each against the committed JAX-CPU oracle at phase 4's bounds; no
      decoder kernel runs;
   b. DIINN with the EDSR-baseline encoder (``BASELINE.json``
      ``configs[0]``: mode 3, hidden 4 x 256) on ``seeded_params``
      weights, Set5 at x2 and x3.14: both forward kernels launched, the
      per-image summaries (mean, mean square, largest magnitude, 256
      seeded pixels of the un-clamped prediction) within 1e-4 relative
      plus 1e-4 of the largest magnitude of the JAX-CPU oracle's;
   c. DIINN mode 3 with ``init_q`` (RDN-B, hidden 4 x 256, seeded
      weights): the output summaries of a seeded batch of 4 48-px LR
      patches at x2.5, at 6b's bounds, and one training step's loss and
      grad norm at phase 5a's step-1 bounds; no decoder kernel runs;
   d. LIIF and MetaSR training: three steps each from the committed
      weights on 5a's batches at 5a's bounds, then ``cli.train``'s
      ``main`` with ``model.arch=<family>`` for 20 steps (validation on
      two images, the checkpoint loads back), with the step's ms (CUDA
      events, steps 2-20) and the host's wait for the next batch;
8. the user's entry points, fp32, from the flagship weights, each path
   with the launch counts set to 0 before it and read after it:
   a. ``cli.demo updown`` of Set5's img0000 (``DEMO_UPDOWN``: LR 64x64 at
      x3.14, x4, x20, ``--streaming on`` at a 0.6 GB budget): only
      ``decode_window_fwd``, once a band; each prediction's summaries
      against the committed JAX-CPU oracle at 6b's bounds; each PNG read
      back equal to the truncated uint8 of its prediction;
   b. ``cli.demo sr`` at the reference demo2's size (``DEMO_SR``: 256x256
      to 5120x5120): streamed at 0.6 GB (band_rows=32, 160 launches) and
      at the default budget (column chunks of 5, 1024 launches), then one
      window over the grid; the three outputs bit-equal (or within 1e-6
      of the largest magnitude, reported), the streaming run's peak device
      memory below the one-window decode's; walls, the band decodes'
      device seconds, the PNG write's and the device-to-host copies' host
      seconds;
   c. ``cli.runtime_bench --iters 20``: its JSON line, each DIINN scale
      launching ``decode_int_fwd`` 22 times, no other family a kernel;
   d. resume through ``cli.train`` (40 steps an epoch, the rate halved at
      step 40): two straight 2-epoch runs, a 1-epoch run and a 2-epoch run
      resumed from it: step 80, step 41's rate half of step 1's, the
      parameters bit-equal to the straight run's if the straight runs
      agree bit for bit, else within twice their largest relative gap,
      with the gradients that differ between two backward passes and
      cuDNN's convolution backward kernels named;
   e. ``cli.train`` for 8 steps with ``trainer.profile_dir``: the trace
      annotates steps 3-5 and names ``decode_fwd_kernel`` and
      ``decode_bwd_chain_kernel`` 9 times each;
   f. ``debug_nans``: two flagship steps with it give the losses of two
      without it, bit for bit (both with cuDNN's deterministic
      algorithms), and a NaN decoder weight raises ``FloatingPointError``;
9. the native loader and the parallel layer, each path with the launch
   counts set to 0 before it and read after it:
   a. the native loader (``native/loader.py``): whether it built, with
      its build seconds or its error; required where ``/usr/include/
      png.h`` and ``jpeglib.h`` both exist. Where it built: its samples
      against the Python path at the JAX package's tolerances, the
      flagship trainer's host wait per step on the numpy path beside 5b's
      and 5d's on the native one, and ``cli.demo sr`` of a committed JPEG;
      where it did not, the demo must refuse the JPEG with its error;
   b. ``cli.train`` as rank 0 of a 1-rank NCCL group (torchrun's
      environment) for 5 flagship steps: losses and parameters bit-equal
      to the plain trainer's, both under cuDNN's deterministic
      algorithms, with both runs' step ms;
   c. the stripes of query sharding, called stripe by stripe:
      ``decode_stripe`` of the flagship weights on Set5 x3.14 and at a
      width of 253 in 2, 3, 8 and 64 stripes (the overhang repeating the
      last column; 4-column stripes), the gathered stripes bit-equal to
      one window; and the flagship step emulated in 2 and 5 stripes
      (``SRTask.stripe_loss``), its loss and gradient norm within phase
      5a's step-1 bounds of the unsharded step; ``decode_window_fwd`` and
      ``decode_window_bwd`` launched once a stripe, with their ms;
   d. two ranks sharing the card over gloo (collectives staged through
      the host), ``cli.train`` for 2 flagship steps at ``mesh_data=2`` and
      at ``mesh_space=2``: rank 0's parameters within rtol 1e-4, atol
      1e-5 of one rank's; NCCL across cards is not measured (one card);
10. the bucketed static-shape eval (``train/bucketed.py``), the benchmark
   CLI's default route: one CUDA graph a bucket, replayed for every image
   of it; each path with the launch counts set to 0 before it and read
   after it:
   a. the flagship evaluation of phase 4 (fp32): the 36 metrics against
      the JAX-CPU oracle at phase 4's bounds and each within 1e-4 of phase
      4's own exact-shape results (the tolerance of JAX's
      ``tests/test_bucketed.py``), 5 programs (``decode_int_fwd`` over LR
      64² -> 256², 128² -> 512², 64² -> 512²; ``decode_window_fwd`` in row
      bands over 128² -> 256², 192² -> 512²), every launch accounted for
      by the warm-ups and the replays; the wall, split into the dataset
      iteration, host prep, copy-in, capture, replay, read-back and the
      rest, and the peak device bytes;
   b. Set5 in bf16 against the JAX-CPU oracle of the same computation
      (fused, interpret mode), within phase 4b's bound: JAX's bucketed
      eval with its x3.14 programs decoded by its window kernel, as the
      port decodes them (JAX's own CLI takes its XLA decoder there, which
      rounds at other points in bf16; the gap to it is reported); made by
      ``python -m tests.test_torch_bucketed --oracle-bf16 PATH``; bf16
      instances only;
   c. LIIF and MetaSR on Set5 against their exact-shape oracles at phase
      6a's bounds, with their program counts; no decoder kernel runs;
   d. each of 10a's programs replayed on its buffers and run eagerly on
      the same buffers: the three metrics bit-equal; one more replay
      under ``torch.profiler``, whose device records must count the
      decoder kernels that 10a booked for a replay (an eager run's count,
      which the wrappers see, is the control); the replay's device ms,
      the eager run's decoder ms, and from them the decoder's seconds in
      10a;
7. a ``kernels`` JSON line (each row with its times at every training
   shape under ``train_shapes``, the forwards' eval shapes under
   ``eval_shapes``; the bf16 instances as rows of their own, ``dtype``
   bfloat16; ``launches_by_path`` with every path above), and last the
   device JSON line.

Any failure raises and exits non-zero; nothing is caught. Without CUDA it
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tpu_diinn_torch import bench
from tpu_diinn_torch.cli import benchmarks, demo, runtime_bench
from tpu_diinn_torch.cli import train as train_cli
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.core import grids
from tpu_diinn_torch.core.fastmath import _SIN_COEFFS
from tpu_diinn_torch.core.resize import resize_by_scale_size, resize_np
from tpu_diinn_torch.data import pipeline
from tpu_diinn_torch.data.png import read_png
from tpu_diinn_torch.kernels import build
from tpu_diinn_torch.native import loader as native_loader
from tpu_diinn_torch.parallel import launch, sharding
from tpu_diinn_torch.kernels import decoder_fused as K
from tpu_diinn_torch.nn.registry import make_net
from tpu_diinn_torch.train import flops, loop, profiling
from tpu_diinn_torch.train.bucketed import _syn_traced
from tpu_diinn_torch.train.checkpoint import (load_params_npz,
                                              seeded_params,
                                              state_dict_from_jax)
from tpu_diinn_torch.train.task import denormalize, normalize

ORACLE = "tpu_diinn_torch/testdata/flagship_benchmarks_jax_cpu.json"
TRAIN_ORACLE = "tpu_diinn_torch/testdata/flagship_train_jax_cpu.json"
BF16_ORACLE = "tpu_diinn_torch/testdata/flagship_bf16_jax_cpu.json"
BF16_WITNESS = "tpu_diinn_torch/testdata/flagship_bf16_port_cpu.json"
BF16_BUCKETED_ORACLE = ("tpu_diinn_torch/testdata/"
                        "flagship_bf16_bucketed_jax_cpu.json")
WEIGHTS = "results/flagship_weights.npz"
WORK = Path("build/chip_smoke")
SOURCES = {"decode_int_fwd": "tpu_diinn_torch/csrc/decoder_fused.cu",
           "decode_window_fwd": "tpu_diinn_torch/csrc/decoder_fused.cu",
           "decode_int_bwd": "tpu_diinn_torch/csrc/decoder_bwd.cu",
           "decode_window_bwd": "tpu_diinn_torch/csrc/decoder_bwd.cu"}
# the bf16 forwards' own kernel (decoder_fused.cu includes it)
FWD_BF16_SOURCE = "tpu_diinn_torch/csrc/decoder_fwd_bf16.cuh"
# the device kernel each launch key runs
DEVICE_KERNEL = {"decode_int_fwd": "decode_fwd_kernel",
                 "decode_window_fwd": "decode_fwd_kernel",
                 "decode_int_fwd_bf16": "decode_fwd_bf16_kernel",
                 "decode_window_fwd_bf16": "decode_fwd_bf16_kernel",
                 "decode_int_bwd": "decode_bwd_chain_kernel",
                 "decode_window_bwd": "decode_bwd_chain_kernel",
                 "decode_int_bwd_bf16": "decode_bwd_chain_bf16_kernel",
                 "decode_window_bwd_bf16": "decode_bwd_chain_bf16_kernel"}
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
BUCKET_TOL = 1e-4          # phase 10a against phase 4 (tests/test_bucketed)
N_PROGRAMS = 5             # phase 10a: kernel x3, traced x2 (quantum 64)
HIDDEN, LAYERS = 256, 4
TRAIN_STEPS, FRACTIONAL_STEPS = 20, 5
FAMILIES = ("liif", "metasr")
FAMILY_WEIGHTS = "results/{}_weights.npz"
FAMILY_ORACLE = "tpu_diinn_torch/testdata/{}_benchmarks_jax_cpu.json"
TPU_LOGS = {             # JAX's metrics taken on a TPU: (log, section)
    "flagship": ("results/benchmarks_flagship_r5b.log", ""),
    "liif": ("results/benchmarks_liif_metasr_r5.log", "=== LIIF"),
    "metasr": ("results/benchmarks_liif_metasr_r5.log", "=== MetaSR"),
    "bicubic": ("results/benchmarks_bicubic_r4.log", "")}
EDSR_ORACLE = "tpu_diinn_torch/testdata/diinn_edsr_jax_cpu.json"
INIT_Q_ORACLE = "tpu_diinn_torch/testdata/init_q_jax_cpu.json"
FAMILIES_TRAIN_ORACLE = "tpu_diinn_torch/testdata/families_train_jax_cpu.json"
# BASELINE.json configs[0], "tiny DIINN": DIINN mode 3, hidden 4 x 256,
# the EDSR-baseline 16-block encoder
EDSR_OVERRIDES = ["model.encoder=edsr-baseline"]
EDSR_SCALES = (2, 3.14)
INIT_Q_OVERRIDES = ["model.init_q=true"]
INIT_Q_SCALE, INIT_Q_BATCH, INIT_Q_HR = 2.5, 4, 120
SEED = 0                   # seeded_params, summaries, init_q_batch
SUMMARY_PIXELS = 256
SUMMARY_TOL = 1e-4         # relative, and of the largest magnitude
BF16 = torch.bfloat16
KERNEL_TOL_BF16 = 2e-3     # bf16 forward: max abs error
BWD_TOL_BF16 = 1e-2        # bf16 backward: max abs error / largest magnitude
MARGIN_BF16 = 1e-3         # relu pre-activation margin of the bf16 chain
FP32_RATIO = 1.5           # bf16 kernel vs fp32 chain, over plain bf16's
DEMO_IMAGE = "data/benchmark/Set5/HR/img0000.png"
DEMO_ORACLE = "tpu_diinn_torch/testdata/demo_streaming_jax_cpu.json"
# phase 8a's demo (its oracle: python -m tests.test_torch_demo
# --streaming-oracle DEMO_ORACLE) and 8b's, the reference demo2's x20
DEMO_UPDOWN = ["updown", "--hr_path", DEMO_IMAGE, "--d_scale", "4",
               "--scales", "3.14", "4", "20", "--streaming", "on",
               "--streaming_hbm_gb", "0.6", "--ckpt_path", WEIGHTS]
DEMO_SR = ["sr", "--lr_path", DEMO_IMAGE, "--output_size", "5120", "5120",
           "--ckpt_path", WEIGHTS]
# what DEMO_SR must do: stream in 160 bands of 32 rows at 0.6 GB, else
# decode in 1024 column chunks of 30000 // 5120 = 5 columns
X20_SIZE = (5120, 5120)
X20_STREAM_LINE = ("[streaming decode: est 0.90 GB > budget 0.60 GB, "
                   "band_rows=32]")
X20_BANDS, X20_CHUNKS = 160, 1024
RUNTIME_ITERS = 20         # phase 8c: timed calls, after 2 warm-up calls
JPEG = "tpu_diinn_torch/testdata/set5_img0000_q90.jpg"   # Set5 img0000
LOADER_HEADERS = ("/usr/include/png.h", "/usr/include/jpeglib.h")
RANK1_STEPS = 5            # phase 9b
STRIPE_SPACES = (2, 3, 8, 64)      # phase 9c: stripes of the eval decode
STRIPE_STEP_SPACES = (2, 5)        # phase 9c: the emulated sharded step
STRIPE_WIDTH = 253                 # phase 9c: a width no space divides
GLOO_STEPS = 2             # phase 9d
HOST_WAIT_MS: dict = {}    # phases 5b and 5d: the host's wait per step


def phase(label: str, t_start: float, **fields) -> None:
    line = {"phase": label,
            "seconds": round(time.perf_counter() - t_start, 3), **fields}
    print(json.dumps(line), flush=True)


def card_peaks(name: str) -> tuple:
    """(fp32 non-tensor FLOP/s, HBM bytes/s, TF32 tensor-core FLOP/s, which
    SKU) from NVIDIA's data sheets, dense rates at the full power limit."""
    if "PCIe" in name:
        return (51.2e12, 2.0e12, 378e12,
                "H100 PCIe: 51.2 TFLOP/s fp32, 378 TF32, 2.0 TB/s")
    return (67.0e12, 3.35e12, 495e12,
            "H100 SXM: 67 TFLOP/s fp32, 495 TF32, 3.35 TB/s")


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


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN held to its deterministic algorithms for the block: its
    default weight-gradient kernels sum in no fixed order, so two default
    fp32 training runs drift apart (``nondeterminism_probe``)."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


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
    """The least time for the work, the larger of its bytes at the HBM
    rate and its matmul FLOP as the kernels run them: fp32-accurate
    products on the tensor cores, three TF32 products each (``bound_ms``);
    and, for reference, the same with the products at the fp32 FFMA rate
    (``bound_ffma_ms``)."""
    t_bytes = nbytes / peaks[1] * 1e3
    t_tc = 3 * flop / peaks[2] * 1e3
    return {"bound_ms": max(t_tc, t_bytes),
            "bound_by": "operations" if t_tc >= t_bytes else "bytes",
            "bound_ffma_ms": max(flop / peaks[0] * 1e3, t_bytes)}


def sass_counts(lib: Path) -> dict:
    """Per kernel of a built library, its count of tensor-core (HMMA,
    HGMMA) and fp32 FFMA instructions, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"cuobjdump": "not found: no instruction counts"}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :")[1].strip())
            counts[name] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA", "FFMA"):
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
                    break
    return counts


def ptxas_by_kernel(log: str) -> dict:
    """Per kernel, ptxas's registers and spill bytes (stores, loads), from
    the ``-Xptxas -v`` log of a build."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)'?", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {})["spill"] = [int(m.group(1)),
                                                 int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def kernel_name(mangled: str) -> str:
    """``decode_bwd_chain_kernel<8,0,Tf32>`` or
    ``decode_bwd_chain_bf16_kernel<8,0,1>`` from its mangled name: the
    length-prefixed name that ends in ``_kernel``, and its template
    arguments (integers, and the precision policy, hopper_chain::Tf32 or
    Bf16). A length prefix may follow digits of the name before it
    (``16decoder_fwd_bf1622decode_fwd_bf16_kernel``), so every tail of a
    run of digits is tried."""
    for m in re.finditer(r"(\d+)", mangled):
        at = m.end()
        for k in range(len(m.group(1))):
            name = mangled[at:at + int(m.group(1)[k:])]
            if re.fullmatch(r"[a-z_][a-z0-9_]*_kernel", name):
                break
        else:
            continue
        args = re.match(r"(?:I(?:L[a-z]+\d+E|N12hopper_chain4(?:Tf32|Bf16)"
                        r"E)+E)?", mangled[at + len(name):]).group(0)
        vals = [a or b for a, b in re.findall(
            r"L[a-z]+(\d+)E|hopper_chain4(Tf32|Bf16)E", args)]
        return name + (f"<{','.join(vals)}>" if vals else "")
    return mangled


def check_fwd(name, fn, ref, n_query, nbytes, peaks, shape,
              reps=20) -> dict:
    out = fn()
    torch.cuda.synchronize()
    want = ref()
    err = (out - want).abs().max().item()
    if not (math.isfinite(err) and err <= KERNEL_TOL):
        raise AssertionError(f"{name} {shape}: max abs error {err} > "
                             f"{KERNEL_TOL}")
    if not torch.equal(out, fn()):
        raise AssertionError(f"{name} {shape}: two calls differ")
    del out, want
    ms = time_ms(fn, reps)
    plain_ms = time_ms(ref, 3)
    flop = n_query * query_flop(HIDDEN, LAYERS)
    return {"name": name, "shape": shape, "max_abs_err": err,
            "deterministic": True, "ms": ms, "plain_ms": plain_ms,
            **bound(flop, nbytes, peaks), "library_ms": None,
            "achieved_tflops": flop / ms / 1e9,
            "ms_by_device_kernel": profile_ms(fn)}


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
    ``torch.profiler``: the passes inside one backward launch, and the
    wrapper's own PyTorch kernels (the weights' split)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t and ("decoder" in e.key or "at::native" in e.key):
            name = e.key.split("(")[0].replace("void ", "")
            if "at::native" in name:
                name = "pytorch: " + name.split("<")[0]
            out[name] = out.get(name, 0.0) + t / reps / 1e3
    return out


def bound_bf16(flop: float, nbytes: float, peaks, peak_bf16: float
               ) -> dict:
    """The least time for a bf16 instance's work: its matmul FLOP at the
    card's bf16 tensor-core peak or its bytes at the HBM rate."""
    t_bytes = nbytes / peaks[1] * 1e3
    t_ops = flop / peak_bf16 * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def as_bf16(z: torch.Tensor, p: dict) -> tuple:
    """z and the weights of ``p`` rounded to bf16 (the biases fp32), as
    the bf16 mode hands them to the kernels; and the same values in fp32,
    the fp32 chain's inputs."""
    zb = z.to(BF16)
    pb = {k: v.to(BF16) if k in K.WEIGHT_KEYS else v for k, v in p.items()}
    return zb, pb, zb.float(), {k: v.float() for k, v in pb.items()}


def check_fwd_bf16(name, fn, ref, ref32, n_query, nbytes, peaks, peak_bf16,
                   shape, reps=20) -> dict:
    """A bf16 forward instance against its plain bf16 version (``ref``)
    and, with it, against the fp32 chain on the same inputs (``ref32``)."""
    out = fn()
    torch.cuda.synchronize()
    want, want32 = ref(), ref32()
    err = (out - want).abs().max().item()
    if not (math.isfinite(err) and err <= KERNEL_TOL_BF16):
        raise AssertionError(f"{name} bf16 {shape}: max abs error {err} > "
                             f"{KERNEL_TOL_BF16}")
    k32 = (out - want32).abs().max().item()
    p32 = (want - want32).abs().max().item()
    if not k32 <= FP32_RATIO * p32 + 1e-5 * want32.abs().max().item():
        raise AssertionError(f"{name} bf16 {shape}: error against the fp32 "
                             f"chain {k32} > {FP32_RATIO} x plain bf16's "
                             f"{p32}")
    if not torch.equal(out, fn()):
        raise AssertionError(f"{name} bf16 {shape}: two calls differ")
    del out, want, want32
    ms = time_ms(fn, reps)
    plain_ms = time_ms(ref, 3)
    flop = n_query * query_flop(HIDDEN, LAYERS)
    return {"name": f"{name}_bf16", "dtype": "bfloat16", "shape": shape,
            "max_abs_err": err, "err_vs_fp32_chain": k32,
            "plain_err_vs_fp32_chain": p32, "deterministic": True,
            "ms": ms, "plain_ms": plain_ms,
            **bound_bf16(flop, nbytes, peaks, peak_bf16), "library_ms": None,
            "achieved_tflops": flop / ms / 1e9,
            "ms_by_device_kernel": profile_ms(fn)}


def check_bwd_bf16(name, fn, ref, ref32, n_query, nbytes, peaks, peak_bf16,
                   shape, masked, reps=5) -> dict:
    """A bf16 backward instance against its plain bf16 version and the
    fp32 chain's backward, output by output (dz and each weight
    gradient)."""
    dz, grads = fn()
    torch.cuda.synchronize()
    (dz_ref, grads_ref), (dz32, grads32) = ref(), ref32()
    errs, rel, vs32 = {}, {}, {}
    for key, got, want, w32 in [("dz", dz, dz_ref, dz32)] + [
            (k, grads[k], grads_ref[k], grads32[k]) for k in K.PARAM_KEYS]:
        got, want = got.float(), want.float()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        errs[key], rel[key] = err, err / scale
        if not (math.isfinite(err) and err <= BWD_TOL_BF16 * scale):
            raise AssertionError(f"{name} bf16 {shape} {key}: max abs error "
                                 f"{err} > {BWD_TOL_BF16} x {scale}")
        k32 = (got - w32).abs().max().item()
        p32 = (want - w32).abs().max().item()
        vs32[key] = {"kernel": k32, "plain": p32}
        if not k32 <= FP32_RATIO * p32 + 1e-5 * scale:
            raise AssertionError(f"{name} bf16 {shape} {key}: error against "
                                 f"the fp32 chain {k32} > {FP32_RATIO} x "
                                 f"plain bf16's {p32}")
    if dz.dtype != BF16 or any(grads[k].dtype != torch.float32
                               for k in K.PARAM_KEYS):
        raise AssertionError(f"{name} bf16: dz {dz.dtype}, grads "
                             f"{[grads[k].dtype for k in K.PARAM_KEYS]}")
    if grads["bcat"][:, :HIDDEN].abs().max().item() != 0.0:
        raise AssertionError(f"{name} bf16: the kq half of dbcat is not zero")
    dz2, grads2 = fn()
    if not (torch.equal(dz, dz2) and all(
            torch.equal(grads[k], grads2[k]) for k in K.PARAM_KEYS)):
        raise AssertionError(f"{name} bf16 {shape}: two calls differ")
    del dz, grads, dz_ref, grads_ref, dz2, grads2, dz32, grads32
    ms = time_ms(fn, reps)
    plain_ms = time_ms(ref, 2)
    flop = n_query * query_flop_bwd(HIDDEN, LAYERS)
    return {"name": f"{name}_bf16", "dtype": "bfloat16", "shape": shape,
            "max_abs_err": max(errs.values()), "max_rel_err": rel,
            "err_vs_fp32_chain": vs32, "masked_queries": masked,
            "deterministic": True, "ms": ms, "plain_ms": plain_ms,
            **bound_bf16(flop, nbytes, peaks, peak_bf16), "library_ms": None,
            "achieved_tflops": flop / ms / 1e9,
            "ms_by_device_kernel": profile_ms(fn)}


def masked_grad_bf16(zb, syn, rows, cols, pb, seed: int):
    """A seeded upstream gradient for a bf16 backward, zero on the queries
    within MARGIN_BF16 of a relu's switch point of the bf16 chain."""
    keep = relu_margin(zb, syn, rows, cols, pb) > MARGIN_BF16
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn((*keep.shape, 3), generator=gen).to(zb.device)
    return (g * keep[..., None]).contiguous(), int((~keep).sum().item())


def eval_kernels(dev, peaks, peak_bf16, t) -> dict:
    """Phase 3: the eval shapes of rows 1 and 2, fp32 and bf16."""
    gen = torch.Generator().manual_seed(0)
    p = flagship_params(gen, dev)
    w_bytes = sum(v.numel() * 4 for v in p.values())
    wb_bytes = sum(v.numel() * (2 if k in K.WEIGHT_KEYS else 4)
                   for k, v in p.items())
    c_all = HIDDEN * LAYERS
    checks = {}
    # exact-shape eval x4 and x8 of a 256x256 image; the bucketed eval's
    # padded canvases LR 128 x4 (Urban100) and LR 64 x8 (every set)
    for h_in, s in ((64, 4), (32, 8), (128, 4), (64, 8)):
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
        zb, pb, z32, p32 = as_bf16(z, p)
        synb = grids.syn_input_grid((h_in, h_in), (h_in * s, h_in * s),
                                    dtype=BF16, device=dev).float()
        res = check_fwd_bf16(
            "decode_int_fwd",
            lambda: K.decode_int_fwd(zb, synb, s, s, pb),
            lambda: K.decode_int_fwd_ref(zb, synb, s, s, pb),
            lambda: K.decode_int_fwd_ref(z32, synb, s, s, p32), nq,
            zb.numel() * 2 + synb.numel() * 4 + wb_bytes + nq * 12, peaks,
            peak_bf16, f"LR {h_in}x{h_in} x{s}")
        phase("kernel", t, **res)
        checks.setdefault("decode_int_fwd_bf16", []).append(res)
        del zb, z32, synb
    # x3.14 on a 256x256 image: LR 82x82, chunks of 30000 // 256 = 117
    # columns (the second chunk, as the chunked eval decodes it); the x20
    # streaming band of the demo's 5120x5120 output of a 256x256 image
    # (one band of 32 rows over all columns); and the bucketed eval's
    # first row band at x3.14 on its padded canvases (the LR features
    # n_z^2, the HR grid n_out^2, the index vectors repeating their last
    # true entry past the image): 82 -> 256 on 128 -> 256 (30000 // 256 =
    # 117 rows), 130 -> 408 on 192 -> 512 (58 rows)
    for h_in, h_out, n_z, n_out, window, what in (
            (82, 256, 82, 256, (0, 256, 117, 234), "columns 117:234"),
            (256, 5120, 256, 5120, (2560, 2592, 0, 5120),
             "rows 2560:2592 (the x20 streaming band)"),
            (82, 256, 128, 256, (0, 117, 0, 256),
             "bucket 128 -> 256, rows 0:117 (bucketed)"),
            (130, 408, 192, 512, (0, 58, 0, 512),
             "bucket 192 -> 512, rows 0:58 (bucketed)")):
        r0, r1, c0, c1 = window
        z = torch.randn((1, n_z, n_z, c_all), generator=gen).to(dev)
        idx = grids.nearest_exact_indices(h_in, h_out)
        idx = np.concatenate([idx, np.full(n_out - h_out, idx[-1],
                                           idx.dtype)])
        rows, cols = idx[r0:r1], idx[c0:c1]
        if n_out == h_out:
            syn = grids.syn_input_grid((h_in, h_in), (h_out, h_out),
                                       device=dev)
        else:
            iv = [torch.tensor(v, dtype=torch.int32, device=dev)
                  for v in (h_in, h_in, h_out, h_out)]
            idx_v = torch.from_numpy(idx).to(dev)
            syn = _syn_traced((n_out, n_out), (n_z, n_z), *iv, idx_v, idx_v)
        syn = syn[r0:r1, c0:c1].contiguous()
        nq = rows.size * cols.size
        touched = np.unique(rows).size * np.unique(cols).size * c_all * 4
        idx_bytes = (rows.size + cols.size) * 4
        rows_v = K.index_vector(rows, n_z, dev)
        cols_v = K.index_vector(cols, n_z, dev)
        shape = f"LR {h_in}x{h_in} -> {h_out}x{h_out}, {what}"
        res = check_fwd(
            "decode_window_fwd",
            lambda: K.decode_window_fwd(z, syn, rows_v, cols_v, p),
            lambda: K.decode_window_fwd_ref(z, syn, rows, cols, p), nq,
            touched + syn.numel() * 4 + w_bytes + nq * 12 + idx_bytes,
            peaks, shape)
        phase("kernel", t, **res)
        checks.setdefault("decode_window_fwd", []).append(res)
        zb, pb, z32, p32 = as_bf16(z, p)
        # the exact route builds its grid in bf16, the bucketed one in fp32
        synb = (grids.syn_input_grid((h_in, h_in), (h_out, h_out),
                                     dtype=BF16, device=dev)[r0:r1, c0:c1]
                .float() if n_out == h_out else syn)
        res = check_fwd_bf16(
            "decode_window_fwd",
            lambda: K.decode_window_fwd(zb, synb, rows_v, cols_v, pb),
            lambda: K.decode_window_fwd_ref(zb, synb, rows, cols, pb),
            lambda: K.decode_window_fwd_ref(z32, synb, rows, cols, p32), nq,
            touched // 2 + synb.numel() * 4 + wb_bytes + nq * 12 + idx_bytes,
            peaks, peak_bf16, shape)
        phase("kernel", t, **res)
        checks.setdefault("decode_window_fwd_bf16", []).append(res)
        del z, zb, z32, syn, synb
    return checks


def bwd_bf16_ptxas() -> dict:
    """ptxas's registers and spills of the bf16 backward's kernels at
    hidden 256 (the chain kernel's instances: <8, window, fold>)."""
    regs = ptxas_by_kernel(build.build_info["decoder_bwd"]["log"])
    return {k: v for k, v in regs.items() if k.startswith((
        "decode_bwd_chain_bf16_kernel<8,", "wgrad_bf16_kernel<8>",
        "tile_sum_kernel", "fold_dz_bf16_kernel<"))}


def scratch_a_query(nq: int, n_pix: int, run: int, dtype) -> float:
    """Bytes of a backward call's scratch a query, without the weight
    gradients' partial sums (``K.bwd_scratch_bytes``)."""
    return K.bwd_scratch_bytes(nq, n_pix, run, HIDDEN, LAYERS, dtype,
                               True) / nq


def train_kernels(dev, peaks, peak_bf16, t, checks: dict) -> None:
    """Phase 3b: rows 3-5 at the flagship training shapes, fp32 and
    bf16; the backward rows with their scratch bytes a query, the bf16
    ones with their kernels' registers and spills."""
    gen = torch.Generator().manual_seed(1)
    p = flagship_params(gen, dev)
    w_bytes = sum(v.numel() * 4 for v in p.values())
    wb_bytes = sum(v.numel() * (2 if k in K.WEIGHT_KEYS else 4)
                   for k, v in p.items())
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
        res["scratch_bytes_a_query"] = scratch_a_query(
            nq, b * h_in * h_in, s * s, torch.float32)
        phase("train_kernel", t, **res)
        checks.setdefault("decode_int_bwd", []).append(res)
        del syn, g
        zb, pb, z32, p32 = as_bf16(z, p)
        synb = grids.syn_input_grid((h_in, h_in), (h_out, h_out),
                                    dtype=BF16, device=dev).float()
        shape = f"train B {b} LR {h_in}x{h_in} x{s}"
        res = check_fwd_bf16(
            "decode_int_fwd",
            lambda: K.decode_int_fwd(zb, synb, s, s, pb),
            lambda: K.decode_int_fwd_ref(zb, synb, s, s, pb),
            lambda: K.decode_int_fwd_ref(z32, synb, s, s, p32), nq,
            z_bytes // 2 + synb.numel() * 4 + wb_bytes + nq * 12, peaks,
            peak_bf16, shape, reps=10)
        phase("train_kernel", t, **res)
        checks.setdefault("decode_int_fwd_bf16_train", []).append(res)
        g, masked = masked_grad_bf16(zb, synb, rows, rows, pb, 10 + s)
        res = check_bwd_bf16(
            "decode_int_bwd",
            lambda: K.decode_int_bwd(zb, synb, s, s, pb, g),
            lambda: K.decode_int_bwd_ref(zb, synb, s, s, pb, g),
            lambda: K.decode_int_bwd_ref(z32, synb, s, s, p32, g), nq,
            z_bytes + synb.numel() * 4 + 2 * wb_bytes + nq * 12, peaks,
            peak_bf16, shape, masked)
        res["scratch_bytes_a_query"] = scratch_a_query(
            nq, b * h_in * h_in, s * s, BF16)
        res["ptxas"] = bwd_bf16_ptxas()
        phase("train_kernel", t, **res)
        checks.setdefault("decode_int_bwd_bf16", []).append(res)
        del zb, z32, synb, g
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
    res["scratch_bytes_a_query"] = scratch_a_query(nq, b * h_in * h_in, 0,
                                                   torch.float32)
    phase("train_kernel", t, **res)
    checks["decode_window_bwd"] = [res]
    del g
    zb, pb, z32, p32 = as_bf16(z, p)
    synb = grids.syn_input_grid((h_in, h_in), (h_out, h_out), dtype=BF16,
                                device=dev).float()
    res = check_fwd_bf16(
        "decode_window_fwd",
        lambda: K.decode_window_fwd(zb, synb, rows_v, rows_v, pb),
        lambda: K.decode_window_fwd_ref(zb, synb, rows, rows, pb),
        lambda: K.decode_window_fwd_ref(z32, synb, rows, rows, p32), nq,
        z_bytes // 2 + synb.numel() * 4 + wb_bytes + nq * 12
        + 2 * rows.size * 4, peaks, peak_bf16, shape, reps=10)
    phase("train_kernel", t, **res)
    checks["decode_window_fwd_bf16_train"] = [res]
    g, masked = masked_grad_bf16(zb, synb, rows, rows, pb, 20)
    res = check_bwd_bf16(
        "decode_window_bwd",
        lambda: K.decode_window_bwd(zb, synb, rows_v, rows_v, pb, g),
        lambda: K.decode_window_bwd_ref(zb, synb, rows, rows, pb, g),
        lambda: K.decode_window_bwd_ref(z32, synb, rows, rows, p32, g), nq,
        z_bytes + synb.numel() * 4 + 2 * wb_bytes + nq * 12
        + 2 * rows.size * 4, peaks, peak_bf16, shape, masked)
    res["scratch_bytes_a_query"] = scratch_a_query(nq, b * h_in * h_in, 0,
                                                   BF16)
    res["ptxas"] = bwd_bf16_ptxas()
    phase("train_kernel", t, **res)
    checks["decode_window_bwd_bf16"] = [res]


def relu_margin(z: torch.Tensor, syn: torch.Tensor, rows, cols,
                params: dict) -> torch.Tensor:
    """Per query (B, len(rows), len(cols)), the smallest |pre-activation|
    of the relus of layers 1..L-1, from the chain in float64.

    The backward masks by ``k > 0``. Where a pre-activation lies within
    rounding distance of zero, two correct fp32 implementations that sum in
    different orders take different sides, and that query's gradient
    differs by a whole term. A comparison of two backward implementations
    therefore zeroes the upstream gradient of the queries whose margin is
    below its tolerance (layer 0's mask reads z itself and is exact). With
    bf16 weights (the bf16 instances) syn and q are rounded to bf16 before
    each product, as the kernels round them."""
    f64 = torch.float64
    cdt = params["w0"].dtype

    def rnd(x):
        return x if cdt == torch.float32 else x.to(cdt).to(f64)
    b = z.shape[0]
    h = params["w0"].shape[1]
    n_layers = params["wcat"].shape[0] + 1
    r = torch.as_tensor(rows, device=z.device).long()
    c = torch.as_tensor(cols, device=z.device).long()
    zt = z[:, r][:, :, c]
    hq, wq = zt.shape[1], zt.shape[2]
    zt = zt.reshape(-1, zt.shape[-1]).to(f64)
    syn64 = rnd(syn.to(f64).expand(b, hq, wq, 3).reshape(-1, 3))
    p = {k: v.detach().to(f64) for k, v in params.items()}

    def sin(x):     # the polynomial sine of core/fastmath, in float64
        y = x - torch.round(x / (2 * math.pi)) * (2 * math.pi)
        acc = torch.full_like(y, _SIN_COEFFS[-1])
        for coeff in _SIN_COEFFS[-2::-1]:
            acc = acc * y * y + coeff
        return y * acc

    q = rnd(torch.relu(zt[:, :h]) * sin(syn64 @ p["w0"] + p["b0"]))
    margin = torch.full((zt.shape[0],), float("inf"), dtype=f64,
                        device=z.device)
    for i in range(1, n_layers):
        both = q @ p["wcat"][i - 1]
        pre = both[:, :h] + zt[:, i * h:(i + 1) * h]
        margin = torch.minimum(margin, pre.abs().amin(dim=1))
        q = rnd(torch.relu(pre) * sin(both[:, h:] + p["bcat"][i - 1, h:]))
    return margin.reshape(b, hq, wq)


def masked_grad(z, syn, rows, cols, p, gen):
    """A seeded upstream gradient, zero on the queries within MARGIN of a
    relu's switch point; and how many queries that zeroes."""
    keep = relu_margin(z, syn, rows, cols, p) > MARGIN
    g = torch.randn((*keep.shape, 3), generator=gen).to(z.device)
    return (g * keep[..., None]).contiguous(), int((~keep).sum().item())


def eval_slice(t) -> tuple:
    """Phase 4: the flagship benchmark evaluation on the exact-shape route;
    returns its launches and its metrics."""
    spans = {name: [] for name in FWD}
    K.reset_launches()
    with contextlib.ExitStack() as stack:
        for name in FWD:
            stack.enter_context(patched(K, name, span_recorder(spans[name])))
        results = benchmarks.main(["--ckpt_path", WEIGHTS, "--device",
                                   "cuda", "--eval_buckets", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(K.launches)
    for name in FWD:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on the "
                                 f"benchmark run: {counts}")
    deltas = hold_metrics(results, ORACLE)
    worst = max(deltas, key=deltas.get)
    tpu_d = max_delta(results, tpu_log_metrics("flagship"))
    phase("slice_eval", t, wall_seconds=round(wall, 3), launches=counts,
          decoder_call_seconds={n: span_seconds(v)
                                for n, v in spans.items()},
          metrics=len(deltas), max_delta_vs_oracle=deltas[worst],
          max_delta_at=worst, max_delta_vs_tpu_v5e_log_info_only=tpu_d)
    return counts, results


def hold_metrics(results: dict, oracle_path: str,
                 sets: tuple = None) -> dict:
    """The benchmark metrics of ``results`` against a committed JAX-CPU
    oracle, all 36 (or those of ``sets``): |dPSNR|, |dLR-PSNR| <= PSNR_TOL
    dB, |dSSIM| <= SSIM_TOL. Returns each metric's |d|."""
    with open(oracle_path) as f:
        oracle = json.load(f)
    if sets is not None:
        oracle = {k: oracle[k] for k in sets}
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
    want_n = N_METRICS if sets is None else 9 * len(sets)
    if len(deltas) != want_n:
        raise AssertionError(f"expected {want_n} metrics, compared "
                             f"{len(deltas)}")
    return deltas


def max_delta(results: dict, other: dict) -> float:
    """The largest |d| between ``results`` and another run's metrics, over
    the sets both have."""
    return max(abs(results[s][k] - v) for s, m in other.items()
               if s in results for k, v in m.items())


def first_batches(cfg, n: int) -> tuple:
    """The first ``n`` training batches of epoch 0 of ``cfg``'s data (host
    numpy, on the numpy path the oracles read), and the steps per epoch."""
    train_ds, _ = loop.make_datasets(cfg, use_native=False)
    it = pipeline.train_batches(
        train_ds, batch_size=cfg.data.batch_size, epoch=0, seed=cfg.seed,
        repeat=cfg.data.trainsets_repeat, num_workers=cfg.data.num_workers)
    batches = [next(it) for _ in range(n)]
    it.close()
    return batches, (len(train_ds) * cfg.data.trainsets_repeat
                     // cfg.data.batch_size)


def hold_steps(got: list, want: list, what: str) -> list:
    """Training steps against a JAX-CPU oracle, relative: step 1's loss
    within LOSS_TOL_1 and grad norm within NORM_TOL_1, later steps both
    within STEP_TOL. Returns the relative gaps."""
    rel = []
    for i, (g, w) in enumerate(zip(got, want)):
        r_loss = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        r_norm = abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
        tol_loss, tol_norm = ((LOSS_TOL_1, NORM_TOL_1) if i == 0
                              else (STEP_TOL, STEP_TOL))
        if not (r_loss <= tol_loss and r_norm <= tol_norm):
            raise AssertionError(f"{what} step {i + 1}: port {g} vs JAX {w} "
                                 f"(relative {r_loss}, {r_norm})")
        rel.append({"loss": r_loss, "grad_norm": r_norm})
    if len(rel) != len(want):
        raise AssertionError(f"{what}: {len(got)} steps, oracle {len(want)}")
    return rel


def train_parity(dev, t) -> dict:
    """Phase 5a: three flagship steps from the committed weights against
    the JAX-CPU oracle."""
    cfg = load_config(None, [])
    with open(TRAIN_ORACLE) as f:
        want = json.load(f)["steps"]
    batches, spe = first_batches(cfg, len(want))
    flat, _ = load_params_npz(WEIGHTS)
    state = loop.init_state(cfg, spe, device=dev, params=flat)
    step = loop.make_train_step(state)
    K.reset_launches()
    got = []
    for batch in batches:
        m = step(loop.to_device(batch, dev))
        got.append({k: float(v) for k, v in m.items()})
    counts = dict(K.launches)
    rel = hold_steps(got, want, "flagship")
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


def timed_train_cli(args: list, tag: str) -> tuple:
    """``run_train_cli`` with CUDA events around each step, the optimizer
    and each decoder kernel call inside a step, and the host's wait
    between steps (host clock). Returns (state, out, records, {"step",
    "fwd", "bwd", "optimizer": [ms]}, [host wait s])."""
    spans = {k: [] for k in ("step", "fwd", "bwd", "optimizer")}
    host_gaps, in_step, last_exit = [], [False], [None]

    def timed_step(make):
        def make_timed(state, **kwargs):
            step = make(state, **kwargs)

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
        state, out, records = run_train_cli(args, tag)
    torch.cuda.synchronize()
    per = {k: [a.elapsed_time(b) for a, b in v] for k, v in spans.items()}
    return state, out, records, per, host_gaps


def train_slice(t, bf16: bool = False) -> dict:
    """Phase 5b (5d's second half with ``bf16``: ``model.dtype=bfloat16``):
    the flagship trainer from the seeded init, with a per-step split read
    from CUDA events."""
    dtype = BF16 if bf16 else torch.float32
    extra = ["model.dtype=bfloat16"] if bf16 else []
    K.reset_launches()
    state, out, records, per, host_gaps = timed_train_cli(
        ["--max-steps", str(TRAIN_STEPS), "trainer.limit_val_images=2",
         *extra], "train_bf16" if bf16 else "train")
    counts = dict(K.launches)
    n = TRAIN_STEPS
    if (counts[K.launch_key("decode_int_bwd", dtype)] != 3 * n
            or counts[K.launch_key("decode_int_fwd", dtype)] < 3 * n):
        raise AssertionError(f"launches over {n} steps: {counts}")
    if bf16 and any(counts[k] for k in K.KERNELS):
        raise AssertionError(f"an fp32 instance ran in bf16 mode: {counts}")
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
    steady = slice(1, None)
    step_ms = float(np.mean(per["step"][steady]))
    fwd_ms = float(np.sum(per["fwd"][3:]) / (n - 1))
    bwd_ms = float(np.sum(per["bwd"][3:]) / (n - 1))
    opt_ms = float(np.mean(per["optimizer"][steady]))
    HOST_WAIT_MS["bfloat16" if bf16 else "float32"] = {
        "host_wait_for_batch": float(np.mean(host_gaps[1:])) * 1e3,
        "step": step_ms}
    phase("slice_train_bf16" if bf16 else "slice_train", t,
          steps=state.step, launches=counts,
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


def train_fractional(t, bf16: bool = False) -> dict:
    """Phase 5c (5e with ``bf16``): scales [2, 2.5] through the window
    kernels; every instance of the run's dtype launched once a step, none
    of the other."""
    dtype = BF16 if bf16 else torch.float32
    K.reset_launches()
    state, _, records = run_train_cli(
        ["--max-steps", str(FRACTIONAL_STEPS), "data.train_scales=[2,2.5]",
         "trainer.log_every_n_steps=1",
         "trainer.check_val_every_n_epoch=1000",
         *(["model.dtype=bfloat16"] if bf16 else [])],
        "fractional_bf16" if bf16 else "fractional")
    torch.cuda.synchronize()
    counts = dict(K.launches)
    n = FRACTIONAL_STEPS
    mine = {K.launch_key(name, dtype) for name in K.KERNELS}
    want = {key: n if key in mine else 0 for key in K.launches}
    if counts != want:
        raise AssertionError(f"launches over {n} steps: {counts}, "
                             f"expected {want}")
    losses = [r["train_loss"] for r in records]
    if not (state.step == n and len(losses) == n
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{state.step} steps, losses {losses}")
    phase("slice_train_fractional_bf16" if bf16 else
          "slice_train_fractional", t, steps=state.step, launches=counts,
          train_loss=losses)
    return counts


def oracle_bound(want: float, other: float, floor: float) -> float:
    """The bound on a bf16 reading: twice the gap between the oracle's
    reading (``want``) and a witness's (``other``), a second correct bf16
    implementation of the same function, and no tighter than the fp32
    phases' ``floor``."""
    return max(2.0 * abs(other - want), floor)


def eval_slice_bf16(t) -> dict:
    """Phase 4b: Set5 at {3.14, 4, 8} in bf16 through the benchmark CLI,
    against the JAX-CPU bf16 oracle."""
    spans = {name: [] for name in FWD}
    K.reset_launches()
    with contextlib.ExitStack() as stack:
        for name in FWD:
            stack.enter_context(patched(K, name, span_recorder(spans[name])))
        results = benchmarks.main(["model.dtype=bfloat16", "--ckpt_path",
                                   WEIGHTS, "--device", "cuda",
                                   "--eval_buckets", "0",
                                   "--testsets", "Set5"])
    torch.cuda.synchronize()
    counts = dict(K.launches)
    for name in FWD:
        if counts[K.launch_key(name, BF16)] <= 0:
            raise AssertionError(f"{name} bf16 was never launched: {counts}")
    if any(counts[k] for k in K.KERNELS):
        raise AssertionError(f"an fp32 instance ran in bf16 mode: {counts}")
    with open(BF16_ORACLE) as f:
        oracle = json.load(f)["set5"]
    deltas, bounds = {}, {}
    for key, want in oracle["fused_interpret"].items():
        got = results["Set5"][key]
        bnd = oracle_bound(want, oracle["xla"][key],
                           SSIM_TOL if "ssim" in key else PSNR_TOL)
        d = abs(got - want)
        if not (math.isfinite(got) and d <= bnd):
            raise AssertionError(f"Set5 bf16 {key}: {got} vs oracle {want} "
                                 f"(|d| {d} > {bnd})")
        deltas[key], bounds[key] = d, bnd
    if len(deltas) != 9:
        raise AssertionError(f"expected 9 metrics, compared {len(deltas)}")
    phase("slice_eval_bf16", t, launches=counts,
          decoder_call_seconds={n: span_seconds(v)
                                for n, v in spans.items()},
          metrics=results["Set5"], delta_vs_oracle=deltas,
          bound=bounds)
    return counts


def bf16_steps(device) -> list:
    """Three flagship bf16 steps from the committed weights on the first
    three batches of epoch 0, on ``device`` (the CPU: the plain decoder
    versions); each step's loss and grad norm."""
    cfg = load_config(None, ["model.dtype=bfloat16"])
    batches, spe = first_batches(cfg, 3)
    flat, _ = load_params_npz(WEIGHTS)
    state = loop.init_state(cfg, spe, device=device, params=flat)
    step = loop.make_train_step(state)
    return [{k: float(v) for k, v in step(loop.to_device(b, device)).items()}
            for b in batches]


def bf16_cpu_witness(path: str) -> None:
    """``--bf16-cpu-witness PATH``: phase 5d's three steps by the port on
    the CPU (the plain decoder versions, the kernels' rounding points;
    oneDNN's bf16 convolutions), written to PATH. No card needed; at
    flagship size, run it on a machine with the memory for it."""
    t0 = time.perf_counter()
    steps = bf16_steps(torch.device("cpu"))
    rec = {"weights": WEIGHTS, "dtype": "bfloat16",
           "platform": "the port (tpu_diinn_torch) on the CPU, plain "
                       "decoder versions",
           "made_by": "python3 chip_smoke.py --bf16-cpu-witness PATH",
           "torch": torch.__version__, "threads": torch.get_num_threads(),
           "batches": "first 3 of epoch 0, DIV2K[0:160)", "steps": steps,
           "seconds": time.perf_counter() - t0}
    Path(path).write_text(json.dumps(rec, indent=1) + "\n")
    print(json.dumps(rec), flush=True)


def train_parity_bf16(dev, t) -> dict:
    """Phase 5d, first half: three flagship bf16 steps from the committed
    weights against the JAX-CPU bf16 oracle's fused route. Each reading's
    witnesses are the correct bf16 implementations of it besides the
    oracle: the port's own steps on the CPU (``BF16_WITNESS``), and for
    the step-1 loss, a forward-only reading, also JAX's XLA route (whose
    bias gradients are summed in bf16, ROADMAP C3, so it witnesses no
    gradient reading); the bound is twice the largest witness gap."""
    with open(BF16_ORACLE) as f:
        steps = json.load(f)["steps"]
    want, xla = steps["fused_interpret"], steps["xla"]
    with open(BF16_WITNESS) as f:
        cpu = json.load(f)["steps"]
    K.reset_launches()
    got = bf16_steps(dev)
    counts = dict(K.launches)
    rel, bounds = [], []
    for i, (g, w, c) in enumerate(zip(got, want, cpu)):
        r, b = {}, {}
        for key in ("loss", "grad_norm"):
            floor = ((LOSS_TOL_1 if key == "loss" else NORM_TOL_1) if i == 0
                     else STEP_TOL)
            witnesses = [c] + ([xla[i]] if (i, key) == (0, "loss") else [])
            b[key] = max(oracle_bound(1.0, x[key] / w[key], floor)
                         for x in witnesses)
            r[key] = abs(g[key] - w[key]) / abs(w[key])
            if not r[key] <= b[key]:
                raise AssertionError(
                    f"bf16 step {i + 1} {key}: port {got} vs JAX {want}, "
                    f"CPU witness {cpu} (relative {r[key]} > {b[key]})")
        rel.append(r)
        bounds.append(b)
    if (counts["decode_int_bwd_bf16"] != 3 * len(want)
            or any(counts[k] for k in K.KERNELS)):
        raise AssertionError(f"launches {counts}")
    phase("slice_train_parity_bf16", t, steps=got, oracle=want,
          cpu_witness=cpu, oracle_xla_route=xla, relative=rel,
          bound=bounds, launches=counts)
    return counts


def step_profile(dev, t, overrides=("model.dtype=bfloat16",),
                 label: str = "step_profile_bf16") -> dict:
    """Phase 5d, last (and 6d's with ``model.arch=liif|metasr``): where a
    training step's device time goes, and how long the device idles.
    ``torch.profiler`` over 5 steps (after 3 warm-up steps) on a seeded
    random batch at the training configuration with ``overrides``; each
    kernel is put in one group by its name. The idle share is 1 - (kernel
    time) / (wall time), one stream, with the wall time of 5 more steps
    timed without the profiler (whose own host cost would count as idle);
    the profiled wall time stands beside it."""
    from torch.profiler import ProfilerActivity, profile
    cfg = load_config(None, list(overrides))
    state = loop.init_state(cfg, 1000, device=dev)
    step = loop.make_train_step(state)
    rng = np.random.default_rng(0)
    batch = loop.to_device(bench._random_batch(
        rng, cfg.data.batch_size, cfg.data.patch_size,
        cfg.data.train_scales), dev)
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        wall_profiled = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        step(batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    def has(*pats):
        return lambda key: any(pt in key for pt in pats)

    # A kernel's name decides its group; the first group that matches wins.
    # cuDNN names a convolution kernel by its direction (fprop, dgrad,
    # wgrad) or as an implicit gemm; cuBLAS's Hopper kernels share cuDNN's
    # "sm90_" / "xmma" prefixes but say "gemm" or "gemv" with none of those
    # words, so only a prefixed kernel without them counts as a convolution.
    # A convolution that cuDNN runs as a plain gemm kernel counts as a matmul.
    is_conv = has("conv", "cudnn", "fprop", "implicit", "wgrad", "dgrad")
    is_matmul = has("gemm", "gemv")
    groups = (("decoder kernels", has("decoder_fused::", "decoder_bwd::")),
              ("convolution (cuDNN)", lambda key: is_conv(key) or (
                  has("xmma", "sm90_")(key) and not is_matmul(key))),
              ("matmul (cuBLAS)", is_matmul),
              ("gathers (index_select, index_add)", has("index", "gather",
                                                        "scatter")),
              ("optimizer", has("adam", "foreach", "multi_tensor")),
              ("copies and casts", has("copy", "cast", "cat")),
              ("elementwise and reductions", has("elementwise", "reduce",
                                                 "vectorized")))
    ms = {g: 0.0 for g, _ in groups}
    ms["other"] = 0.0
    kernels = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t_ms = getattr(e, "device_time_total", 0) / n / 1e3
        kernels += t_ms
        key = e.key.lower()
        g = next((g for g, match in groups if match(key)), "other")
        ms[g] += t_ms
    out = {"wall_ms_per_step": wall,
           "wall_ms_per_step_profiled": wall_profiled,
           "kernel_ms_per_step": kernels,
           "device_idle_share": (1.0 - kernels / wall) if kernels else None,
           "kernel_ms_by_group": ms}
    phase(label, t, **out)
    return out


def bench_line(t) -> None:
    """Phase 5f: the bench, its JSON line printed on a line of its own."""
    rec = bench.run("cuda")
    print(json.dumps(rec), flush=True)
    phase("bench", t, value=rec["value"], mfu_bf16=rec["mfu_bf16"],
          steps_per_s=rec["steps_per_s"])


def eval_family(t, family: str) -> dict:
    """Phase 6a: a family's benchmark evaluation through the benchmark
    CLI (the committed weights of LIIF or MetaSR, or ``--bicubic_test``),
    fp32, against its JAX-CPU oracle; no decoder kernel may run."""
    K.reset_launches()
    args = (["--bicubic_test"] if family == "bicubic"
            else ["--ckpt_path", FAMILY_WEIGHTS.format(family)])
    results = benchmarks.main(args + ["--device", "cuda", "--eval_buckets",
                                      "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(K.launches)
    if any(counts.values()):
        raise AssertionError(f"{family}: a decoder kernel ran: {counts}")
    deltas = hold_metrics(results, FAMILY_ORACLE.format(family))
    worst = max(deltas, key=deltas.get)
    phase(f"slice_eval_{family}", t, wall_seconds=round(wall, 3),
          launches=counts, metrics=len(deltas),
          max_delta_vs_oracle=deltas[worst], max_delta_at=worst,
          max_delta_vs_tpu_v5e_log_info_only=max_delta(
              results, tpu_log_metrics(family)))
    return counts


def tpu_log_metrics(family: str) -> dict:
    """The JAX package's metrics of ``family`` taken on a TPU (a sanity
    check, printed for information only): the last JSON line of its
    section of the committed log."""
    path, header = TPU_LOGS[family]
    lines = Path(path).read_text().splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith(header))
    rest = lines[start + 1:]
    end = next((i for i, ln in enumerate(rest) if ln.startswith("===")),
               len(rest))
    return json.loads([ln for ln in rest[:end] if ln.startswith("{")][-1])


def summarize(pred, seed: int = SEED) -> dict:
    """What the summary oracles hold of an un-clamped prediction: its mean
    and mean square (float64 sums), its largest magnitude, and
    SUMMARY_PIXELS values at positions drawn from ``seed``."""
    p = np.asarray(pred, dtype=np.float64).ravel()
    idx = np.random.default_rng(seed).integers(0, p.size, SUMMARY_PIXELS)
    return {"mean": float(p.mean()), "mean_sq": float(np.mean(p * p)),
            "max_abs": float(np.abs(p).max()), "pixels": p[idx].tolist()}


def hold_summary(got: dict, want: dict, what: str) -> float:
    """``summarize`` readings against the oracle's: each within SUMMARY_TOL
    relative plus SUMMARY_TOL of the oracle's largest magnitude (fp32 sums
    in another order). Returns the largest |d| over that magnitude."""
    keys = ("mean", "mean_sq", "max_abs")
    g = np.array([got[k] for k in keys] + got["pixels"])
    w = np.array([want[k] for k in keys] + want["pixels"])
    d = np.abs(g - w)
    if not (np.isfinite(g).all()
            and (d <= SUMMARY_TOL * (np.abs(w) + want["max_abs"])).all()):
        i = int(np.argmax(d - SUMMARY_TOL * np.abs(w)))
        raise AssertionError(f"{what}: reading {i} {g[i]} vs oracle {w[i]}")
    return float(d.max() / want["max_abs"])


def edsr_eval_inputs():
    """(key, LR image, HR size) of Set5 at EDSR_SCALES, in the benchmark
    loop's order; the key is "<image index>/x<scale>"."""
    cfg = load_config(None, EDSR_OVERRIDES)
    cfg.data.test_scales = list(EDSR_SCALES)
    cfg.data.testsets = [("benchmark", "Set5")]
    dset = loop.make_test_datasets(cfg)["Set5"]
    for i, batch in pipeline.eval_batches(dset):
        for s, (lr, hr, _name) in batch.items():
            yield f"{i}/x{s:g}", lr, (hr.shape[1], hr.shape[2])


def eval_diinn_edsr(dev, t) -> dict:
    """Phase 6b: DIINN with the EDSR-baseline encoder (mode 3, hidden
    4 x 256) on ``seeded_params`` weights, Set5 at x2 (``decode_int_fwd``)
    and x3.14 (``decode_window_fwd``, column chunks of eval_bsize),
    against the JAX-CPU oracle's per-image summaries."""
    with open(EDSR_ORACLE) as f:
        want = json.load(f)["images"]
    task = loop.build_task(load_config(None, EDSR_OVERRIDES), device=dev)
    task.net.load_state_dict(state_dict_from_jax(
        seeded_params(task.net, SEED)), strict=True)
    K.reset_launches()
    got = {}
    with torch.inference_mode():
        for key, lr, size in edsr_eval_inputs():
            pred = task.net(normalize(torch.from_numpy(lr).to(dev)), size,
                            task.eval_bsize)
            got[key] = summarize(pred.cpu().numpy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(K.launches)
    for name in FWD:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched: {counts}")
    if set(got) != set(want):
        raise AssertionError(f"images {sorted(got)} vs {sorted(want)}")
    rel = {k: hold_summary(got[k], want[k], f"diinn+edsr {k}")
           for k in want}
    worst = max(rel, key=rel.get)
    phase("slice_eval_diinn_edsr", t, wall_seconds=round(wall, 3),
          launches=counts, images=len(rel), max_rel_delta=rel[worst],
          max_rel_delta_at=worst)
    return counts


def init_q_batch(seed: int = SEED) -> dict:
    """A seeded batch {2.5: (lr, hr)}: INIT_Q_BATCH HR patches of uniform
    noise, INIT_Q_HR px, and their antialiased bicubic 48-px LR."""
    rng = np.random.default_rng(seed)
    hr = rng.uniform(0, 1, (INIT_Q_BATCH, INIT_Q_HR, INIT_Q_HR, 3)).astype(
        np.float32)
    lr = np.clip(resize_np(hr, (48, 48)), 0.0, 1.0).astype(np.float32)
    return {INIT_Q_SCALE: (lr, hr)}


def init_q_step(dev, t) -> dict:
    """Phase 6c: DIINN mode 3 with ``init_q`` (RDN-B, hidden 4 x 256) on
    ``seeded_params`` weights: the un-clamped output of ``init_q_batch``
    and one training step (loss, grad norm) against the JAX-CPU oracle, at
    phase 5a's step-1 bounds. init_q runs no decoder kernel."""
    with open(INIT_Q_ORACLE) as f:
        want = json.load(f)
    cfg = load_config(None, INIT_Q_OVERRIDES)
    flat = seeded_params(make_net("diinn", init_q=True), SEED)
    state = loop.init_state(cfg, 1000, device=dev, params=flat)
    batch = loop.to_device(init_q_batch(), dev)
    (lr, hr), = batch.values()
    K.reset_launches()
    with torch.no_grad():
        pred = state.task.net(normalize(lr), (hr.shape[1], hr.shape[2]))
    out = summarize(pred.cpu().numpy())
    got = {k: float(v) for k, v in loop.make_train_step(state)(batch).items()}
    counts = dict(K.launches)
    if any(counts.values()):
        raise AssertionError(f"init_q: a decoder kernel ran: {counts}")
    rel = hold_steps([got], [want["step"]], "init_q")
    phase("slice_init_q", t, step=got, oracle=want["step"], relative=rel[0],
          output_max_rel_delta=hold_summary(out, want["output"],
                                            "init_q output"),
          launches=counts)
    return counts


def train_families(dev, t) -> dict:
    """Phase 6d: for LIIF and MetaSR, three ``make_train_step`` steps from
    the committed weights on the flagship's first three batches against
    the JAX-CPU oracle (phase 5a's bounds); then ``cli.train``'s ``main``
    with ``model.arch=<family>`` from the seeded init for TRAIN_STEPS
    steps, validation on two images and the checkpoint, with the step's
    CUDA-event ms (steps 2-20) and the host's wait for the next batch."""
    with open(FAMILIES_TRAIN_ORACLE) as f:
        oracle = json.load(f)
    K.reset_launches()
    out = {}
    for fam in FAMILIES:
        cfg = load_config(None, [f"model.arch={fam}"])
        want = oracle[fam]["steps"]
        batches, spe = first_batches(cfg, len(want))
        flat, _ = load_params_npz(FAMILY_WEIGHTS.format(fam))
        state = loop.init_state(cfg, spe, device=dev, params=flat)
        step = loop.make_train_step(state)
        got = [{k: float(v) for k, v in
                step(loop.to_device(b, dev)).items()} for b in batches]
        rel = hold_steps(got, want, fam)
        del state, step
        t_cli = time.perf_counter()
        state, ckpt, records, per, host_gaps = timed_train_cli(
            ["--max-steps", str(TRAIN_STEPS), f"model.arch={fam}",
             "trainer.limit_val_images=2"], f"train_{fam}")
        val = records[-1]
        if not (state.step == TRAIN_STEPS
                and math.isfinite(val["train_loss"])
                and math.isfinite(val["val_loss"])):
            raise AssertionError(f"{fam} training record {val}")
        flat, meta = load_params_npz(str(ckpt / "last.npz"))
        make_net(fam).load_state_dict(state_dict_from_jax(flat), strict=True)
        out[fam] = {"steps": got, "oracle": want, "relative": rel,
                    "cli_seconds": round(time.perf_counter() - t_cli, 3),
                    "train_loss": val["train_loss"],
                    "val_loss": val["val_loss"],
                    "step_ms": float(np.mean(per["step"][1:])),
                    "host_wait_for_batch_ms":
                        float(np.mean(host_gaps[1:])) * 1e3,
                    "step_ms_all": per["step"]}
        del state
        torch.cuda.empty_cache()
    counts = dict(K.launches)
    if any(counts.values()):
        raise AssertionError(f"LIIF/MetaSR: a decoder kernel ran: {counts}")
    phase("slice_train_families", t, launches=counts, **out)
    return counts


def captured(fn, *args):
    """``fn(*args)`` with its standard output captured, then printed;
    returns (its result, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue().splitlines()


def host_timer(seconds: list):
    """A wrapper that appends each call's host seconds to ``seconds``."""
    def wrap(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            seconds.append(time.perf_counter() - t0)
            return out
        return call
    return wrap


def only_window_launches(counts: dict, n: int, what: str) -> None:
    """``decode_window_fwd`` (fp32) launched ``n`` times, nothing else."""
    want = {k: n if k == "decode_window_fwd" else 0 for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def demo_updown(t) -> dict:
    """Phase 8a: ``cli.demo`` ``updown`` of Set5's img0000 (LR 64x64) at
    x3.14, x4 and x20 with ``--streaming on`` and a 0.6 GB budget, from the
    flagship weights: every band one ``decode_window_fwd`` launch (x4 too,
    no ``decode_int_fwd``); each prediction's summaries against the
    JAX-CPU oracle at 6b's bounds; each PNG, read back, equal to the
    truncated uint8 of its prediction."""
    with open(DEMO_ORACLE) as f:
        want = json.load(f)["outputs"]
    out_dir = WORK / "demo_updown"
    shutil.rmtree(out_dir, ignore_errors=True)
    K.reset_launches()
    written, lines = captured(demo.main, DEMO_UPDOWN + [
        "--out_dir", str(out_dir), "--device", "cuda"])
    torch.cuda.synchronize()
    counts = dict(K.launches)
    bands = [int(m.group(1)) for m in
             (re.search(r"band_rows=(\d+)", ln) for ln in lines) if m]
    if len(bands) != len(want):
        raise AssertionError(f"streaming lines {lines}")
    n_bands = sum(math.ceil(w["size"][0] / b)
                  for w, b in zip(want.values(), bands))
    only_window_launches(counts, n_bands, "demo updown")
    rel = {}
    for key, w in want.items():
        path = str(out_dir / f"default_model_img0000_{key}.png")
        pred = written[path]
        if list(pred.shape[1:3]) != w["size"]:
            raise AssertionError(f"{key}: shape {pred.shape}")
        rel[key] = hold_summary(summarize(pred), w, f"demo updown {key}")
        png = read_png(path)
        quant = (np.clip(pred[0], 0, 1) * 255).astype(np.uint8)
        if not np.array_equal(png, quant):
            raise AssertionError(f"{path}: the PNG is not the truncated "
                                 f"uint8 of the prediction")
    phase("demo_updown", t, launches=counts, band_rows=bands,
          max_rel_delta_vs_oracle=rel, pngs_exact=len(rel))
    return counts


def demo_sr_full(dev, t) -> dict:
    """Phase 8b: ``cli.demo sr`` at the reference demo2's size (256x256 to
    5120x5120, x20, 26.2 M queries) from the flagship weights: streamed at
    a 0.6 GB budget (band_rows=32: 160 ``decode_window_fwd`` launches),
    and at the default budget in column chunks of eval_bsize // 5120 = 5
    columns (1024 launches); then one window over the whole grid. The
    three outputs must be bit-equal (the same chain per query, tiled
    otherwise), and the streaming run's peak device memory below the
    one-window decode's. Returns the launches of each run."""
    runs, preds, counts = {}, {}, {}
    for tag, extra, n, line in (
            ("streaming", ["--streaming_hbm_gb", "0.6"], X20_BANDS,
             X20_STREAM_LINE),
            ("chunked", [], X20_CHUNKS, None)):
        out_dir = WORK / f"demo_sr_{tag}"
        shutil.rmtree(out_dir, ignore_errors=True)
        spans, save_s = [], []
        K.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patched(K, "decode_window_fwd", span_recorder(spans)), \
                patched(demo, "_save_image", host_timer(save_s)):
            written, lines = captured(demo.main, DEMO_SR + extra + [
                "--out_dir", str(out_dir), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[f"demo_sr_{tag}"] = dict(K.launches)
        only_window_launches(K.launches, n, f"demo sr {tag}")
        streamed = [ln for ln in lines if ln.startswith("[streaming")]
        if streamed != ([line] if line else []):
            raise AssertionError(f"demo sr {tag}: printed {lines}")
        (pred,) = written.values()
        preds[tag] = np.asarray(pred, dtype=np.float32)
        runs[tag] = {"wall_seconds": wall,
                     "decode_window_fwd_device_seconds": span_seconds(spans),
                     "png_write_host_seconds": save_s[0],
                     "peak_device_bytes": torch.cuda.max_memory_allocated()}
        del written, pred
    # one window over the whole grid, as the demo's net computes it
    args = argparse.Namespace(model_name="default_model", ckpt_path=WEIGHTS)
    task = demo._build(args, [], dev)
    lr = torch.from_numpy(demo._load_image(DEMO_IMAGE)).to(dev)
    K.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, b = events()
    with torch.inference_mode():
        a.record()
        whole = torch.clamp(denormalize(task.net(normalize(lr), X20_SIZE,
                                                 None)), 0, 1)
        b.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds["one_window"] = whole.cpu().numpy()
        d2h = time.perf_counter() - t0
        band = whole[:, :32].contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(X20_BANDS):
            band.cpu()
        d2h_bands = time.perf_counter() - t0
    counts["demo_sr_one_window"] = dict(K.launches)
    only_window_launches(K.launches, 1, "one window")
    runs["one_window"] = {
        "device_seconds": a.elapsed_time(b) / 1e3,
        "d2h_host_seconds": d2h,
        "d2h_host_seconds_of_the_bands": d2h_bands,
        "peak_device_bytes": torch.cuda.max_memory_allocated()}
    del whole, band, task
    ref = preds["one_window"]
    scale = float(np.abs(ref).max())
    diffs = {k: float(np.abs(v - ref).max()) for k, v in preds.items()}
    if any(d > 1e-6 * scale for d in diffs.values()):
        raise AssertionError(f"x20 decodes differ: {diffs} (largest "
                             f"magnitude {scale})")
    if not (runs["streaming"]["peak_device_bytes"]
            < runs["one_window"]["peak_device_bytes"]):
        raise AssertionError(f"streaming peak not below one window: {runs}")
    phase("demo_sr_x20", t, runs=runs, max_abs_diff_vs_one_window=diffs,
          bit_equal=all(np.array_equal(v, ref) for v in preds.values()),
          launches=counts)
    torch.cuda.empty_cache()
    return counts


def runtime_table(t) -> dict:
    """Phase 8c: ``cli.runtime_bench`` with ``--iters 20`` (its JSON on a
    line of its own): each DIINN scale launches ``decode_int_fwd`` exactly
    2 + 20 times (warm-up and timed calls), no other family any decoder
    kernel."""
    per_call = []

    def counting(fn):
        def call(*args, **kwargs):
            before = dict(K.launches)
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            per_call.append({k: v - before[k] for k, v in K.launches.items()
                             if v != before[k]})
            return out
        return call
    K.reset_launches()
    with patched(runtime_bench, "synced_time", counting):
        results = runtime_bench.main(["--iters", str(RUNTIME_ITERS),
                                      "--device", "cuda"])
    counts = dict(K.launches)
    by_key = dict(zip(results, per_call))
    for key, got in by_key.items():
        want = ({"decode_int_fwd": 2 + RUNTIME_ITERS}
                if key.startswith("diinn_") else {})
        if got != want:
            raise AssertionError(f"runtime_bench {key}: launches {got}, "
                                 f"expected {want}")
    phase("runtime_bench", t, ms=results, launches=counts)
    return counts


def params_gap(a: dict, b: dict) -> float:
    """The largest relative gap between two state dicts: max over tensors
    of max |a - b| / max |a|."""
    return max(float((a[k] - b[k]).abs().max() / a[k].abs().max().clamp(
        min=1e-30)) for k in a)


def train_resume(dev, t) -> dict:
    """Phase 8d: resume through ``cli.train`` on DIV2K at 40 steps an
    epoch (``data.trainsets_repeat=1``), the rate halving at step 40
    (``model.lr_step=1``), with cuDNN held to its deterministic
    algorithms: two straight 2-epoch runs (their gap is the witness), a
    1-epoch run, and a 2-epoch run resumed from it. The resumed run ends
    at step 80 with step 41's rate half of step 1's. If the two straight
    runs agree bit for bit, the resumed run must equal them bit for bit;
    else (the fallback) it must be within twice the straight runs' largest
    relative gap, and ``nondeterminism_probe`` names the gradients and
    kernels that differ between two runs. Also reports what the
    deterministic algorithms cost a flagship step."""
    base = ["data.trainsets_repeat=1", "model.lr_step=1",
            "trainer.limit_val_images=2"]
    lrs = {}

    def recording(tag):
        def wrap(fn):
            def call(state):
                lrs.setdefault(tag, []).append(
                    state.optimizer.param_groups[0]["lr"])
                return fn(state)
            return call
        return wrap
    K.reset_launches()
    states, secs = {}, {}
    with cudnn_deterministic():
        for tag, extra in (
                ("straight_a", ["trainer.max_epochs=2"]),
                ("straight_b", ["trainer.max_epochs=2"]),
                ("part", ["trainer.max_epochs=1"]),
                ("resumed", ["trainer.max_epochs=2",
                             f"trainer.resume={WORK / 'resume_part'}"])):
            t0 = time.perf_counter()
            with patched(loop, "apply_update", recording(tag)):
                state, _, _ = run_train_cli(base + extra, f"resume_{tag}")
            torch.cuda.synchronize()
            secs[tag] = time.perf_counter() - t0
            states[tag] = {k: v.detach().clone() for k, v in
                           state.task.net.state_dict().items()}
            if tag == "resumed":
                steps = state.step
            del state
    counts = dict(K.launches)
    if not (steps == 80 and len(lrs["resumed"]) == 40
            and lrs["resumed"][0] == 0.5 * lrs["part"][0]):
        raise AssertionError(f"resumed run: step {steps}, rates of steps 1 "
                             f"and 41 {lrs['part'][:1]}, {lrs['resumed'][:1]}")
    witness = params_gap(states["straight_a"], states["straight_b"])
    gap = params_gap(states["straight_a"], states["resumed"])
    straight_equal = all(torch.equal(v, states["straight_b"][k])
                         for k, v in states["straight_a"].items())
    resumed_equal = all(torch.equal(v, states["resumed"][k])
                        for k, v in states["straight_a"].items())
    if straight_equal and not resumed_equal:
        raise AssertionError(f"the straight runs agree bit for bit, the "
                             f"resumed run does not (relative gap {gap})")
    if not straight_equal and not gap <= 2 * witness:
        raise AssertionError(f"resumed vs straight: relative gap {gap} > "
                             f"2 x the straight runs' {witness}")
    probe = None if straight_equal else nondeterminism_probe(dev)
    phase("train_resume", t, steps=steps, lr_step1=lrs["part"][0],
          lr_step41=lrs["resumed"][0], cudnn_deterministic=True,
          straight_runs_bit_equal=straight_equal,
          resumed_bit_equal=resumed_equal, straight_runs_rel_gap=witness,
          resumed_rel_gap=gap, cli_seconds=secs,
          step_ms=deterministic_step_cost(dev), nondeterminism=probe,
          launches=counts)
    return counts


def deterministic_step_cost(dev, warmup: int = 3, iters: int = 10) -> dict:
    """Mean device ms of a flagship fp32 training step (committed weights,
    the first batch of epoch 0, repeated) by default and under
    ``cudnn_deterministic``, in turns: default, deterministic,
    deterministic, default."""
    cfg = load_config(None, [])
    (host_batch,), spe = first_batches(cfg, 1)
    flat, _ = load_params_npz(WEIGHTS)
    state = loop.init_state(cfg, spe, device=dev, params=flat)
    step = loop.make_train_step(state)
    batch = loop.to_device(host_batch, dev)
    ms = {"default": [], "cudnn_deterministic": []}
    for tag in ("default", "cudnn_deterministic", "cudnn_deterministic",
                "default"):
        with (cudnn_deterministic() if tag != "default"
              else contextlib.nullcontext()):
            for _ in range(warmup):
                step(batch)
            a, b = events()
            a.record()
            for _ in range(iters):
                step(batch)
            b.record()
            torch.cuda.synchronize()
        ms[tag].append(a.elapsed_time(b) / iters)
    del state, step, batch
    torch.cuda.empty_cache()
    out = {k: float(np.mean(v)) for k, v in ms.items()}
    out["turns"] = ms
    out["cost"] = out["cudnn_deterministic"] / out["default"] - 1.0
    return out


def nondeterminism_probe(dev) -> dict:
    """Which gradients of a flagship step differ between two backward
    passes on the same batch and weights: by default, and with
    ``torch.backends.cudnn.deterministic`` (cuDNN restricted to its
    deterministic algorithms); the input image's gradient (cuDNN's dgrad
    through the encoder) and each parameter's; and the cuDNN convolution
    backward kernels that the default step runs (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = load_config(None, [])
    (host_batch,), spe = first_batches(cfg, 1)
    flat, _ = load_params_npz(WEIGHTS)
    state = loop.init_state(cfg, spe, device=dev, params=flat)
    net = state.task.net

    def grads():
        batch = loop.to_device(host_batch, dev)
        for lr, _ in batch.values():
            lr.requires_grad_(True)
        net.zero_grad(set_to_none=True)
        state.task.train_loss(batch).backward()
        out = {n: p.grad.clone() for n, p in net.named_parameters()}
        out.update({f"input x{s:g}": lr.grad.clone()
                    for s, (lr, _) in batch.items()})
        return out

    def differing():
        a, b = grads(), grads()
        return sorted(k for k in a if not torch.equal(a[k], b[k]))
    default = differing()
    with cudnn_deterministic():
        deterministic = differing()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        grads()
        torch.cuda.synchronize()
    conv_bwd = sorted({e.key for e in prof.key_averages()
                       if any(w in e.key.lower() for w in ("wgrad", "dgrad"))})
    del state, net
    torch.cuda.empty_cache()
    return {"differing_grads_default": len(default),
            "differing_examples": default[:6],
            "decoder_grads_differ": any(k.startswith("decoder.")
                                        for k in default),
            "differing_grads_cudnn_deterministic": deterministic,
            "cudnn_conv_backward_kernels": conv_bwd}


def train_profile(t) -> dict:
    """Phase 8e: ``cli.train`` for 8 steps with ``trainer.profile_dir``:
    the Chrome trace covers steps 3-5 (after two warm-up steps), and names
    ``decode_fwd_kernel`` and ``decode_bwd_chain_kernel`` 9 times each, 3
    a step."""
    prof_dir = WORK / "profile"
    shutil.rmtree(prof_dir, ignore_errors=True)
    K.reset_launches()
    t0 = time.perf_counter()
    run_train_cli(["--max-steps", "8", f"trainer.profile_dir={prof_dir}",
                   "trainer.profile_steps=3",
                   "trainer.check_val_every_n_epoch=1000"], "train_profile")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(K.launches)
    (trace,) = prof_dir.glob("*.pt.trace.json")
    events_ = json.loads(trace.read_text())["traceEvents"]
    steps = sorted(e["name"] for e in events_
                   if e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("train_step "))
    kernels = {name: sum(1 for e in events_ if e.get("cat") == "kernel"
                         and name in e.get("name", ""))
               for name in ("decode_fwd_kernel", "decode_bwd_chain_kernel")}
    if steps != [f"train_step {i}" for i in (3, 4, 5)] or any(
            n != 9 for n in kernels.values()):
        raise AssertionError(f"profile: steps {steps}, kernels {kernels}")
    phase("train_profile", t, trace=str(trace),
          trace_bytes=trace.stat().st_size, steps=steps,
          kernel_events=kernels, cli_seconds=secs, launches=counts)
    return counts


def debug_nans(dev, t) -> dict:
    """Phase 8f: two flagship steps (from the committed weights, on the
    first batches of epoch 0) with ``debug_nans`` give the same losses as
    without it, bit for bit; both run with cuDNN held to its deterministic
    algorithms (``cudnn_deterministic``), as phase 8d's runs do: two
    default runs may differ in step 2. A
    third step with one decoder weight set to NaN must raise
    ``FloatingPointError``; any other exception ends the run."""
    cfg = load_config(None, [])
    batches, spe = first_batches(cfg, 3)
    flat, _ = load_params_npz(WEIGHTS)
    K.reset_launches()
    losses, secs = {}, {}
    with cudnn_deterministic():
        for tag, on in (("off", False), ("on", True)):
            state = loop.init_state(cfg, spe, device=dev, params=flat)
            step = loop.make_train_step(state, debug_nans=on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profiling.enable_debug_nans(on):
                losses[tag] = [float(step(loop.to_device(b, dev))["loss"])
                               for b in batches[:2]]
            torch.cuda.synchronize()
            secs[tag] = time.perf_counter() - t0
    if losses["on"] != losses["off"]:
        raise AssertionError(f"debug_nans changed the losses: {losses}")
    state.task.net.decoder.q1.dense.weight.data[0, 0] = float("nan")
    with profiling.enable_debug_nans(True):
        try:
            step(loop.to_device(batches[2], dev))
        except FloatingPointError as e:
            raised = str(e)
        else:
            raise AssertionError("a NaN decoder weight did not raise under "
                                 "debug_nans")
    counts = dict(K.launches)
    phase("debug_nans", t, losses=losses, raised=raised,
          host_seconds_two_steps=secs, launches=counts)
    del state, step
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 9: the native loader and the parallel layer.
# ---------------------------------------------------------------------------

def native_loader_phase(t) -> dict:
    """Phase 9a. Whether the native loader built (g++ with libpng and
    libjpeg; its error if not), required where this machine has both
    headers. Where it built: decode, resize, ``sample_patch`` and DIV2K
    dataset samples against the Python path at the JAX package's
    tolerances (exact, 1e-4, 1e-6, 1e-5); the flagship trainer's host wait
    for the next batch over 20 steps on the numpy path
    (``make_datasets(use_native=False)``), fp32 and bf16, beside phases 5b
    and 5d's on the native path; and ``cli.demo sr`` of a JPEG made from
    Set5's img0000, its PNG read back equal to the truncated uint8 of its
    prediction. Where it did not build: phases 5b and 5d took the numpy
    path, and the demo must refuse the JPEG with the build's error."""
    headers = {h: Path(h).exists() for h in LOADER_HEADERS}
    t0 = time.perf_counter()
    ok = native_loader.available()
    out = {"available": ok, "headers": headers,
           "build_seconds": native_loader.build_seconds,
           "build_error": native_loader.build_error(),
           "load_seconds": time.perf_counter() - t0}
    if all(headers.values()) and not ok:
        raise AssertionError(f"the native loader did not build on a machine "
                             f"with its headers: {out['build_error']}")
    waits = {"native" if ok else "numpy": dict(HOST_WAIT_MS)}
    jpg_out = WORK / "demo_jpeg"
    demo_args = ["sr", "--lr_path", JPEG, "--output_size", "512", "512",
                 "--ckpt_path", WEIGHTS, "--out_dir", str(jpg_out)]
    K.reset_launches()
    if ok:
        errs = {}
        for p in (DEMO_IMAGE, "data/DIV2K/DIV2K_train_HR/0001.png"):
            img = native_loader.decode_image(p)
            if not np.array_equal(img, read_png(p)):
                raise AssertionError(f"decode_image({p}) != read_png")
        img = native_loader.decode_image(DEMO_IMAGE).astype(np.float32)
        errs["resize"] = float(np.abs(native_loader.resize_bicubic(
            img, (97, 61)) - resize_np(img, (97, 61))).max())
        img8 = read_png(DEMO_IMAGE)
        lr, hr = native_loader.sample_patch(img8, 7, 30, 144, 48, True,
                                            False, True)
        crop = img8[7:151, 30:174].astype(np.float32)
        want_lr = np.transpose(resize_np(crop, (48, 48))[::-1], (1, 0, 2))
        errs["sample_patch"] = max(
            float(np.abs(lr - want_lr / 255.0).max()),
            float(np.abs(hr - np.transpose(crop[::-1], (1, 0, 2))
                         / 255.0).max()))
        from tpu_diinn_torch.data import datasets as ds
        kw = dict(root="data", name="DIV2K", scales=[2, 3, 4],
                  patch_size=48)
        a = ds.SRDatasetDownsample(use_native=True, **kw)
        b = ds.SRDatasetDownsample(use_native=False, **kw)
        errs["dataset"] = max(
            float(np.abs(x[k] - y[k]).max())
            for i in (0, 17, 101)
            for x, y in zip(a.sample(i, np.random.default_rng(i)).values(),
                            b.sample(i, np.random.default_rng(i)).values())
            for k in (0, 1))
        bounds = {"resize": 1e-4, "sample_patch": 1e-6, "dataset": 1e-5}
        bad = {k: v for k, v in errs.items() if not v <= bounds[k]}
        if bad:
            raise AssertionError(f"native vs Python path: {bad} > {bounds}")
        out["max_abs_err"] = errs
        numpy_path = functools.partial(loop.make_datasets, use_native=False)
        waits["numpy"] = {}
        with patched(loop, "make_datasets", lambda fn: numpy_path):
            for dt, extra in (("float32", []),
                              ("bfloat16", ["model.dtype=bfloat16"])):
                *_, per, gaps = timed_train_cli(
                    ["--max-steps", str(TRAIN_STEPS),
                     "trainer.limit_val_images=2", *extra],
                    f"train_numpy_{dt}")
                waits["numpy"][dt] = {
                    "host_wait_for_batch": float(np.mean(gaps[1:])) * 1e3,
                    "step": float(np.mean(per["step"][1:]))}
        written = demo.main(demo_args)
        (path, pred), = written.items()
        back = read_png(path)
        q = (torch.clamp(torch.as_tensor(pred)[0], 0, 1) * 255).to(
            torch.uint8).numpy()
        if back.shape != (512, 512, 3) or not np.array_equal(back, q):
            raise AssertionError("the JPEG demo's PNG is not its prediction")
        out["jpeg_demo"] = {"input": JPEG, "output": path}
    else:
        try:
            demo.main(demo_args)
        except RuntimeError as e:
            if "native loader unavailable" not in str(e):
                raise
            out["jpeg_demo"] = f"refused: {str(e)[:200]}"
        else:
            raise AssertionError("the demo read a JPEG without the loader")
    counts = dict(K.launches)
    phase("native_loader", t, host_wait_ms_per_step=waits, launches=counts,
          **out)
    return counts


def rank_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port)}


def rank1_nccl(t) -> dict:
    """Phase 9b: ``cli.train`` at the flagship defaults for
    ``RANK1_STEPS`` steps, plain and then as rank 0 of a 1-rank NCCL
    process group (torchrun's environment): the NCCL run goes through the
    mesh trainer's collectives (the loss and gradient all-reduces, the
    epoch's barrier). Under ``cudnn_deterministic`` both runs' per-step
    losses and final parameters must be bit-equal; with each run's step ms
    (CUDA events, steps 2-N)."""
    import torch.distributed as dist
    base = ["--max-steps", str(RANK1_STEPS), "trainer.limit_val_images=1",
            "trainer.log_every_n_steps=1"]
    K.reset_launches()
    runs = {}
    with cudnn_deterministic():
        for tag in ("plain", "nccl"):
            env = rank_env(0, 1, launch.free_port()) if tag == "nccl" else {}
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                state, _, records, per, _ = timed_train_cli(
                    base, f"rank1_{tag}")
                if tag == "nccl":
                    if not (dist.is_initialized()
                            and dist.get_backend() == "nccl"
                            and dist.get_world_size() == 1):
                        raise AssertionError("no 1-rank NCCL group")
                    dist.destroy_process_group()
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            runs[tag] = {
                "losses": [r["train_loss"] for r in records
                           if "grad_norm" in r],
                "params": {k: v.detach().clone() for k, v in
                           state.task.net.state_dict().items()},
                "step_ms": float(np.mean(per["step"][1:]))}
            del state
    counts = dict(K.launches)
    a, b = runs["plain"], runs["nccl"]
    if len(a["losses"]) != RANK1_STEPS or a["losses"] != b["losses"]:
        raise AssertionError(f"1-rank NCCL losses {b['losses']} != plain "
                             f"{a['losses']}")
    if not all(torch.equal(v, b["params"][k]) for k, v in a["params"].items()):
        raise AssertionError(f"1-rank NCCL params differ: relative gap "
                             f"{params_gap(a['params'], b['params'])}")
    phase("rank1_nccl", t, losses=a["losses"], bit_equal=True,
          step_ms={k: v["step_ms"] for k, v in runs.items()},
          phase5b_step_ms=HOST_WAIT_MS.get("float32", {}).get("step"),
          launches=counts)
    return counts


PLAIN_WINDOW = {"decode_window_fwd": lambda: K.decode_window_fwd_ref,
                "decode_window_bwd": lambda: K.decode_window_bwd_ref}


def shape_recorder(name: str, calls: list, inputs: dict):
    """A wrapper of a window kernel's dispatcher that records, per call,
    (name, (B, h, w, z's LR columns read), a pair of CUDA events), and the
    first call's inputs of each (name, shape) in ``inputs``."""
    def wrap(fn):
        def call(z, syn, rows, cols, params, *args, **kwargs):
            a, b = events()
            a.record()
            out = fn(z, syn, rows, cols, params, *args, **kwargs)
            b.record()
            key = (name, (z.shape[0], syn.shape[0], syn.shape[1],
                          int(torch.unique(cols).numel())))
            calls.append((*key, (a, b)))
            g = args[:1] if name.endswith("bwd") else ()   # not slabs
            inputs.setdefault(key, (z, syn, rows, cols, params, *g))
            return out
        return call
    return wrap


@torch.no_grad()
def stripe_table(calls: list, inputs: dict, peaks, z_shape) -> list:
    """Mean ms by (kernel, shape) of ``shape_recorder``'s calls, the plain
    version's ms on the first call's inputs, and the bound of each: its
    matmul FLOP in 3xTF32 against the bytes it must move (z's rows x the
    stripe's LR columns, syn, the weights, the output; the backward also g
    and dz)."""
    h, n = HIDDEN, LAYERS
    w_bytes = 4 * (3 * h + h + (n - 1) * 3 * h * h + h * 3 + 3)
    groups: dict = {}
    for name, shape, ev in calls:
        groups.setdefault((name, shape), []).append(ev)
    rows = []
    for (name, (b, hh, ww, lr_cols)), evs in sorted(groups.items()):
        args = inputs[(name, (b, hh, ww, lr_cols))]
        plain = PLAIN_WINDOW[name]()
        plain_ms = time_ms(lambda: plain(*args), 2)
        nq = b * hh * ww
        bwd = name.endswith("bwd")
        z_bytes = b * z_shape[1] * lr_cols * h * n * 4 * (2 if bwd else 1)
        nbytes = z_bytes + hh * ww * 12 + w_bytes + nq * 12 * (2 if bwd
                                                              else 1)
        flop = nq * (query_flop_bwd(h, n) if bwd else query_flop(h, n))
        rows.append({"name": name, "shape": [b, hh, ww], "lr_cols": lr_cols,
                     "calls": len(evs),
                     "ms": float(np.mean([x.elapsed_time(y)
                                          for x, y in evs])),
                     "plain_ms": plain_ms,
                     **{k: v for k, v in bound(flop, nbytes, peaks).items()
                        if k != "bound_ffma_ms"}})
    return rows


def stripes(dev, peaks, t) -> dict:
    """Phase 9c, the stripes of query sharding at full width, called
    stripe by stripe in this process (``ImplicitDecoder.decode_stripe``,
    each one ``decode_window_fwd`` over the stripe's column index vector):

    - eval: the flagship weights on Set5's img0000 at x3.14 (256 x 256)
      and at a width no space divides (256 x ``STRIPE_WIDTH``), in
      ``STRIPE_SPACES`` stripes (64: 4-column stripes, narrower than the
      kernels' query tile); the gathered stripes, overhang cut, must be
      bit-equal to one window over the grid;
    - training: the flagship step (committed weights, phase 5a's first
      batch) emulated stripe by stripe, ``SRTask.stripe_loss`` of each of
      ``STRIPE_STEP_SPACES`` stripes, its gradients summed: the loss and
      the gradient norm held to the unsharded step at phase 5a's step-1
      bounds (relative 1e-5 and 5e-4), with the largest relative gap of
      any parameter's gradient reported.

    With every stripe's device ms (CUDA events) by shape, beside its
    bound (``stripe_table``)."""
    flat, _ = load_params_npz(WEIGHTS)
    net = make_net("diinn").to(dev)
    net.load_state_dict(state_dict_from_jax(flat), strict=True)
    hr = read_png(DEMO_IMAGE).astype(np.float32)[None] / 255.0
    lr_size = resize_by_scale_size(hr.shape[1:3], 3.14)
    x = normalize(torch.from_numpy(resize_np(hr[0], lr_size))[None].to(dev))
    K.reset_launches()
    calls, inputs = [], {}
    eval_out = {}
    with patched(K, "decode_window_fwd",
                 shape_recorder("decode_window_fwd", calls, inputs)), \
            torch.inference_mode():
        feat = net.encoder(x)
        for size in ((256, 256), (256, STRIPE_WIDTH)):
            whole = net.decoder.windows(feat, size)(0, size[0],
                                                    slice(0, size[1]))
            for n in STRIPE_SPACES:
                width = sharding.stripe_width(size[1], n)
                parts = [net.decoder.decode_stripe(feat, size, s * width,
                                                   width)
                         for s in range(n)]
                got = torch.cat(parts, dim=2)[:, :, :size[1]]
                torch.cuda.synchronize()
                if not torch.equal(got, whole):
                    raise AssertionError(
                        f"{n} stripes of {size} != one window: max "
                        f"{(got - whole).abs().max().item()}")
                eval_out[f"{size[0]}x{size[1]}/{n}"] = {
                    "stripe_w": width, "overhang": n * width - size[1]}
    torch.cuda.synchronize()
    eval_counts = dict(K.launches)
    eval_table = stripe_table(calls, inputs, peaks, feat.shape)
    want_fwd = 2 * (1 + sum(STRIPE_SPACES))
    if eval_counts["decode_window_fwd"] != want_fwd:
        raise AssertionError(f"stripe eval launches {eval_counts}, "
                             f"decode_window_fwd {want_fwd} expected")

    cfg = load_config(None, [])
    batches, spe = first_batches(cfg, 1)
    state = loop.init_state(cfg, spe, device=dev, params=flat)
    task = state.task
    params = list(task.net.parameters())
    batch = loop.to_device(batches[0], dev)
    loss = task.train_loss(batch)
    loss.backward()
    want = [p.grad.detach().clone() for p in params]
    want_norm = float(torch.stack([g.square().sum() for g in want]).sum()
                      .sqrt())
    K.reset_launches()
    loss = float(loss.detach())
    train_out = {}
    calls, inputs = [], {}
    with contextlib.ExitStack() as stack:
        for name in ("decode_window_fwd", "decode_window_bwd"):
            stack.enter_context(patched(
                K, name, shape_recorder(name, calls, inputs)))
        for n in STRIPE_STEP_SPACES:
            for p in params:
                p.grad = None
            total = 0.0
            for s in range(n):
                part = task.stripe_loss(batch, s, n)
                part.backward()
                total += float(part.detach())
            grads = [p.grad for p in params]
            norm = float(torch.stack([g.square().sum() for g in grads])
                         .sum().sqrt())
            rel = {"loss": abs(total - loss) / loss,
                   "grad_norm": abs(norm - want_norm) / want_norm,
                   "max_grad_rel_gap": max(
                       float((g - w).abs().max() / w.abs().max().clamp(
                           min=1e-30)) for g, w in zip(grads, want))}
            if not (rel["loss"] <= LOSS_TOL_1
                    and rel["grad_norm"] <= NORM_TOL_1):
                raise AssertionError(f"{n} stripes of the flagship step: "
                                     f"{rel}")
            train_out[n] = {"loss": total, "grad_norm": norm, **rel}
    torch.cuda.synchronize()
    train_counts = dict(K.launches)
    n_calls = 3 * sum(STRIPE_STEP_SPACES)
    if (train_counts["decode_window_fwd"] != n_calls
            or train_counts["decode_window_bwd"] != n_calls):
        raise AssertionError(f"stripe step launches {train_counts}, "
                             f"{n_calls} of each window kernel expected")
    lr_shape = (1, batches[0][2][0].shape[1])
    phase("stripes", t, eval=eval_out, eval_launches=eval_counts,
          eval_ms=eval_table,
          train_unsharded={"loss": loss, "grad_norm": want_norm},
          train=train_out, train_launches=train_counts,
          train_ms=stripe_table(calls, inputs, peaks, lr_shape))
    del state, task, params, want
    torch.cuda.empty_cache()
    return {"stripes_eval": eval_counts, "stripes_train": train_counts}


def gloo_shared_card(t) -> dict:
    """Phase 9d: two ranks on this one card over gloo (NCCL refuses two
    ranks on one device; the port's collectives stage CUDA tensors through
    the host under gloo), each ``cli.train`` at the flagship defaults for
    ``GLOO_STEPS`` steps, at ``mesh_data=2`` and at ``mesh_data=1,
    mesh_space=2``; rank 0's parameters held to this process's one-rank
    run of the same steps (rtol 1e-4, atol 1e-5, as
    ``tests/test_multihost.py``). Reports the outcome either way: a layout
    that fails is named with its error, and fails the phase."""
    base = ["--max-steps", str(GLOO_STEPS), "trainer.check_val_every_n_epoch"
            "=1000", "data.num_workers=2"]
    K.reset_launches()
    state, *_ = run_train_cli(base, "gloo_one_rank")
    want = {k: v.detach().cpu().numpy() for k, v in
            state.task.net.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    counts = dict(K.launches)
    out = {}
    with launch.RankPool(2, device_type="cuda", backend="gloo",
                         share_device=True, threads=4, timeout=300) as pool:
        for tag, extra in (("data2", ["trainer.mesh_data=2"]),
                           ("space2", ["trainer.mesh_data=1",
                                       "trainer.mesh_space=2"])):
            t0 = time.perf_counter()
            res = pool.run("chip_smoke:gloo_rank_train",
                           base + extra, str(WORK / f"gloo_{tag}"))
            got = res[0]["params"]
            close = all(np.allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
                        for k in want)
            for r in res:
                for k, v in r["launches"].items():
                    counts[k] += v
            out[tag] = {"params_close": close,
                        "max_abs_err": max(float(np.abs(got[k] - want[k])
                                                 .max()) for k in want),
                        "step_ms_by_rank": [r["step_ms"] for r in res],
                        "wall_seconds": time.perf_counter() - t0,
                        "launches_by_rank": [r["launches"] for r in res]}
            if not close:
                raise AssertionError(f"gloo {tag}: rank 0's params differ "
                                     f"from one rank: {out[tag]}")
    phase("gloo_shared_card", t, ranks=2, backend="gloo", runs=out,
          nccl_multi_card="not measured: one card on this machine",
          launches=counts)
    return counts


def gloo_rank_train(args: list, out_dir: str) -> dict:
    """One rank of phase 9d: ``cli.train`` with CUDA events around each
    step; its kernel launches, mean step ms (steps 2-N) and (rank 0) its
    parameters."""
    import torch.distributed as dist
    K.reset_launches()
    spans = []

    def timed(make):
        def make_timed(state, **kwargs):
            step = make(state, **kwargs)

            def call(batch):
                a, b = events()
                a.record()
                m = step(batch)
                b.record()
                spans.append((a, b))
                return m
            return call
        return make_timed
    with patched(loop, "make_train_step", timed):
        state = train_cli.main(["--device", "cuda", *args,
                                f"trainer.ckpt_dir={out_dir}",
                                f"trainer.log_dir={out_dir}"])
    torch.cuda.synchronize()
    res = {"launches": dict(K.launches),
           "step_ms": float(np.mean([a.elapsed_time(b)
                                     for a, b in spans[1:]]))}
    if dist.get_rank() == 0:
        res["params"] = {k: v.detach().cpu().numpy() for k, v in
                         state.task.net.state_dict().items()}
    return res


def keeping_instances(cls, made: list):
    """``cls`` as a factory that keeps every instance it makes in
    ``made``."""
    def make(*args, **kwargs):
        obj = cls(*args, **kwargs)
        made.append(obj)
        return obj
    return make


def timed_batches(seconds: list):
    """A wrapper of ``pipeline.eval_batches`` that adds the host's wait for
    each next batch (PNG decode and LR generation) to ``seconds[0]``."""
    def wrap(fn):
        def gen(*args, **kwargs):
            it = iter(fn(*args, **kwargs))
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    seconds[0] += time.perf_counter() - t0
                    return
                seconds[0] += time.perf_counter() - t0
                yield item
        return gen
    return wrap


def bucketed_cli(args: list) -> tuple:
    """``benchmarks.main(args)`` on its default (bucketed) route: its
    results, its ``BucketedEval``, the host seconds of its split and its
    peak device bytes."""
    made, wait = [], [0.0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(benchmarks, "BucketedEval",
                 lambda cls: keeping_instances(cls, made)), \
            patched(pipeline, "eval_batches", timed_batches(wait)):
        results = benchmarks.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(made) != 1:
        raise AssertionError(f"{args}: {len(made)} bucketed evaluators")
    ev = made[0]
    split = {"dataset_iteration": wait[0], **ev.seconds}
    split["rest"] = wall - sum(split.values())
    return results, ev, wall, split, torch.cuda.max_memory_allocated()


def replay_launches(ev, counts: dict) -> dict:
    """Each program's launches a run, checked against ``counts``: one
    eager warm-up and every replay of every program, nothing else."""
    want = {k: 0 for k in counts}
    per_program = {}
    for key, prog in ev._programs.items():
        for k, n in prog.launches.items():
            want[k] += (1 + prog.replays) * n
        per_program["/".join(map(str, key))] = {
            "replays": prog.replays, "launches_a_run": prog.launches}
    if want != counts:
        raise AssertionError(f"launches {counts}, the warm-ups and replays "
                             f"make {want}")
    return per_program


def eval_bucketed(t, exact: dict) -> tuple:
    """Phase 10a: the flagship benchmark evaluation (4 sets x {3.14, 4,
    8}, fp32) through the benchmark CLI's default route, the bucketed
    eval: the 36 metrics against the JAX-CPU oracle at phase 4's bounds
    and within BUCKET_TOL of phase 4's exact-shape results, N_PROGRAMS
    programs, both forward kernels launched and counted per replay.
    Returns the evaluator (phase 10d replays its graphs) and the
    launches."""
    K.reset_launches()
    results, ev, wall, split, peak = bucketed_cli(
        ["--ckpt_path", WEIGHTS, "--device", "cuda"])
    counts = dict(K.launches)
    for name in FWD:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on the "
                                 f"bucketed run: {counts}")
    programs = replay_launches(ev, counts)
    if ev.n_programs != N_PROGRAMS:
        raise AssertionError(f"{ev.n_programs} programs, expected "
                             f"{N_PROGRAMS}: {list(programs)}")
    deltas = hold_metrics(results, ORACLE)
    vs_exact = {f"{s}/{k}": abs(v - exact[s][k])
                for s, m in results.items() for k, v in m.items()}
    worst = max(vs_exact, key=vs_exact.get)
    if vs_exact[worst] > BUCKET_TOL:
        raise AssertionError(f"{worst}: bucketed {vs_exact[worst]} from the "
                             f"exact route (> {BUCKET_TOL})")
    worst_o = max(deltas, key=deltas.get)
    phase("slice_eval_bucketed", t, wall_seconds=round(wall, 3),
          split_seconds={k: round(v, 4) for k, v in split.items()},
          peak_device_bytes=peak, n_programs=ev.n_programs,
          programs=programs, launches=counts, metrics=len(deltas),
          max_delta_vs_oracle=deltas[worst_o], max_delta_at=worst_o,
          max_delta_vs_exact_route=vs_exact[worst], max_exact_at=worst)
    return ev, counts


def eval_bucketed_bf16(t) -> dict:
    """Phase 10b: Set5 at {3.14, 4, 8} in bf16 on the bucketed route,
    against the JAX-CPU oracle of the same computation (``model.use_fused=
    true``, interpret mode): JAX's bucketed eval with its x4 and x8
    programs on its integer kernel and its x3.14 programs decoded by its
    window kernel (``bucketed_window``; JAX's own CLI decodes them with
    XLA, which rounds at other points in bf16), each metric within phase
    4b's bound (twice the gap between JAX's XLA and fused exact routes, no
    tighter than phase 4's); the gap to JAX's CLI route is reported. bf16
    instances only."""
    K.reset_launches()
    results, ev, wall, split, peak = bucketed_cli(
        ["model.dtype=bfloat16", "--ckpt_path", WEIGHTS, "--device", "cuda",
         "--testsets", "Set5"])
    counts = dict(K.launches)
    for name in FWD:
        if counts[K.launch_key(name, BF16)] <= 0:
            raise AssertionError(f"{name} bf16 was never launched: {counts}")
    if any(counts[k] for k in K.KERNELS):
        raise AssertionError(f"an fp32 instance ran in bf16 mode: {counts}")
    replay_launches(ev, counts)
    with open(BF16_ORACLE) as f:
        exact_oracle = json.load(f)["set5"]
    with open(BF16_BUCKETED_ORACLE) as f:
        oracles = json.load(f)["set5"]
    deltas, bounds, vs_cli = {}, {}, {}
    for key, want in oracles["bucketed_window"].items():
        got = results["Set5"][key]
        floor = SSIM_TOL if "ssim" in key else PSNR_TOL
        bnd = oracle_bound(exact_oracle["fused_interpret"][key],
                           exact_oracle["xla"][key], floor)
        d = abs(got - want)
        if not (math.isfinite(got) and d <= bnd):
            raise AssertionError(f"Set5 bf16 bucketed {key}: {got} vs "
                                 f"oracle {want} (|d| {d} > {bnd})")
        deltas[key], bounds[key] = d, bnd
        vs_cli[key] = abs(got - oracles["bucketed"][key])
    if len(deltas) != 9:
        raise AssertionError(f"expected 9 metrics, compared {len(deltas)}")
    phase("slice_eval_bucketed_bf16", t, wall_seconds=round(wall, 3),
          split_seconds={k: round(v, 4) for k, v in split.items()},
          n_programs=ev.n_programs, launches=counts,
          metrics=results["Set5"], delta_vs_oracle=deltas, bound=bounds,
          delta_vs_jax_cli_route=vs_cli)
    return counts


def eval_bucketed_family(t, family: str) -> dict:
    """Phase 10c: LIIF or MetaSR on Set5 at {3.14, 4, 8}, bucketed, fp32:
    the 9 metrics against the Set5 entries of the family's exact-shape
    JAX-CPU oracle at phase 6a's bounds; no decoder kernel runs."""
    K.reset_launches()
    results, ev, wall, split, _ = bucketed_cli(
        ["--ckpt_path", FAMILY_WEIGHTS.format(family), "--device", "cuda",
         "--testsets", "Set5"])
    counts = dict(K.launches)
    if any(counts.values()):
        raise AssertionError(f"{family}: a decoder kernel ran: {counts}")
    deltas = hold_metrics(results, FAMILY_ORACLE.format(family), ("Set5",))
    worst = max(deltas, key=deltas.get)
    phase(f"slice_eval_bucketed_{family}", t, wall_seconds=round(wall, 3),
          split_seconds={k: round(v, 4) for k, v in split.items()},
          n_programs=ev.n_programs, launches=counts, metrics=len(deltas),
          max_delta_vs_oracle=deltas[worst], max_delta_at=worst)
    return counts


def device_launches(run) -> dict:
    """The decoder forward kernels that ``run()`` puts on the card, by
    wrapper key, counted from the device's own records (``torch.profiler``,
    CUPTI): a graph's replay runs kernels that no wrapper sees."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"decode_fwd(_bf16)?_kernel<\d+, (true|false)", e.key)
        if m is None:
            continue
        name = FWD[1] if m.group(2) == "true" else FWD[0]
        if m.group(1):
            name = K.launch_key(name, BF16)
        out[name] = out.get(name, 0) + e.count
    return out


def bucketed_replay_check(t, ev) -> dict:
    """Phase 10d: each of phase 10a's programs replayed once more on its
    buffers (the last image of its bucket) and run eagerly by the same
    function on the same buffers: the three metrics bit-equal (a graph
    that baked in a scalar or kept a stale pointer would differ). Each
    program replayed once more under ``torch.profiler``: the decoder
    kernels the graph runs, counted on the device, equal the launches
    that 10a booked for each replay (the count of an eager run of the
    same program, which the wrappers see, is the counting's control).
    With each replay's device ms (CUDA events) and each eager run's
    decoder calls' device ms, and from them the decoder's share of phase
    10a."""
    K.reset_launches()
    out, decoder_s = {}, 0.0
    replays = {key: prog.replays for key, prog in ev._programs.items()}
    for key, n in replays.items():
        a, b = events()
        a.record()
        res = ev.replay(key)
        b.record()
        torch.cuda.synchronize()
        got, replay_ms = res.tolist(), a.elapsed_time(b)
        spans = {name: [] for name in FWD}
        with contextlib.ExitStack() as stack:
            for name in FWD:
                stack.enter_context(patched(K, name,
                                            span_recorder(spans[name])))
            want = ev.eager(key).tolist()
        torch.cuda.synchronize()
        if got != want:
            raise AssertionError(f"{key}: replay {got} != eager {want}")
        booked = ev._programs[key].launches
        before = dict(K.launches)
        control = device_launches(lambda: ev.eager(key))
        by_wrappers = {k: v - before[k] for k, v in K.launches.items()
                       if v != before[k]}
        if control != by_wrappers:
            raise AssertionError(f"{key}: the profiler counted {control} "
                                 f"in an eager run, the wrappers "
                                 f"{by_wrappers}")
        on_device = device_launches(lambda: ev.replay(key))
        if on_device != booked:
            raise AssertionError(f"{key}: a replay ran {on_device} on the "
                                 f"device, 10a booked {booked}")
        dec_ms = sum(span_seconds(v) for v in spans.values()) * 1e3
        decoder_s += dec_ms * n / 1e3
        out["/".join(map(str, key))] = {
            "metrics": got, "replay_ms": replay_ms,
            "eager_decoder_ms": dec_ms, "replays_in_10a": n,
            "launches_a_replay_booked": booked,
            "launches_a_replay_on_device": on_device}
    phase("bucketed_replay_vs_eager", t, bit_equal=True,
          launches_counted_on_device=True, programs=out,
          decoder_seconds_in_10a_from_eager=decoder_s,
          launches=dict(K.launches))
    return dict(K.launches)


def main(argv: list) -> int:
    if argv[:1] == ["--bf16-cpu-witness"] and len(argv) == 2:
        bf16_cpu_witness(argv[1])
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", flush=True)
        return 2
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
    peak_bf16 = flops.PEAK_FLOPS[(flops.sku(kind), "bfloat16")]
    phase("device", t, nvidia_smi=smi, kind=kind,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          peaks=peaks[3], bf16_peak_tflops=peak_bf16 / 1e12)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2) build: one nvcc per library, started together
    t = time.perf_counter()
    build.load_all()
    for name, info in build.build_info.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        sass = sass_counts(build.library_path(name))
        if "cuobjdump" not in sass:
            # kernel name prefixes: every instance has tensor-core
            # instructions, every bf16 one (a Bf16 policy argument, or the
            # backward's own bf16 kernels) HGMMA
            need = {"decoder_fused": (("decode_fwd", ("HGMMA",)),),
                    "decoder_bwd": (("decode_bwd_chain", ("HMMA", "HGMMA")),
                                    ("wgrad", ("HMMA", "HGMMA")))}
            for kern, ops in need[name]:
                tc = [sum(v[op] for op in ops) for k, v in sass.items()
                      if k.startswith(kern)]
                if not tc or min(tc) == 0:
                    raise AssertionError(f"{kern}: an instance without "
                                         f"{'/'.join(ops)}: {sass}")
                hg = [v["HGMMA"] for k, v in sass.items()
                      if k.startswith(kern) and (k.endswith("Bf16>")
                                                 or "_bf16_kernel" in k)]
                if not hg or min(hg) == 0:
                    raise AssertionError(f"{kern}: a bf16 instance without "
                                         f"HGMMA: {sass}")
        phase("build", t, library=name,
              nvcc_seconds=round(info["seconds"], 3),
              path=str(build.library_path(name)), ptxas=regs,
              registers_by_kernel=ptxas_by_kernel(info["log"]),
              sass_counts=sass)

    # 3) and 3b) kernels against their plain versions
    t = time.perf_counter()
    checks = eval_kernels(dev, peaks, peak_bf16, t)
    t = time.perf_counter()
    train_kernels(dev, peaks, peak_bf16, t, checks)
    torch.cuda.empty_cache()

    # 4) and 5) the main paths, each with the launch counts set to 0 just
    # before it and read just after
    by_path = {}
    by_path["eval"], exact_results = eval_slice(time.perf_counter())
    by_path["train_parity"] = train_parity(dev, time.perf_counter())
    by_path["train"] = train_slice(time.perf_counter())
    by_path["train_fractional"] = train_fractional(time.perf_counter())
    by_path["eval_bf16"] = eval_slice_bf16(time.perf_counter())
    by_path["train_parity_bf16"] = train_parity_bf16(dev, time.perf_counter())
    by_path["train_bf16"] = train_slice(time.perf_counter(), bf16=True)
    by_path["train_fractional_bf16"] = train_fractional(time.perf_counter(),
                                                        bf16=True)
    step_profile(dev, time.perf_counter())
    bench_line(time.perf_counter())
    torch.cuda.empty_cache()
    for fam in ("liif", "metasr", "bicubic"):
        by_path[f"eval_{fam}"] = eval_family(time.perf_counter(), fam)
    by_path["eval_diinn_edsr"] = eval_diinn_edsr(dev, time.perf_counter())
    by_path["init_q"] = init_q_step(dev, time.perf_counter())
    by_path["train_families"] = train_families(dev, time.perf_counter())
    for fam in FAMILIES:
        step_profile(dev, time.perf_counter(), [f"model.arch={fam}"],
                     f"step_profile_{fam}")
    torch.cuda.empty_cache()

    # 8) the user's entry points
    by_path["demo_updown"] = demo_updown(time.perf_counter())
    by_path.update(demo_sr_full(dev, time.perf_counter()))
    by_path["runtime_bench"] = runtime_table(time.perf_counter())
    by_path["train_resume"] = train_resume(dev, time.perf_counter())
    by_path["train_profile"] = train_profile(time.perf_counter())
    by_path["debug_nans"] = debug_nans(dev, time.perf_counter())
    torch.cuda.empty_cache()

    # 9) the native loader and the parallel layer
    by_path["native_loader"] = native_loader_phase(time.perf_counter())
    by_path["rank1_nccl"] = rank1_nccl(time.perf_counter())
    by_path.update(stripes(dev, peaks, time.perf_counter()))
    by_path["gloo_shared_card"] = gloo_shared_card(time.perf_counter())
    torch.cuda.empty_cache()

    # 10) the bucketed static-shape eval, the benchmark CLI's default route
    ev, by_path["eval_bucketed"] = eval_bucketed(time.perf_counter(),
                                                 exact_results)
    by_path["eval_bucketed_bf16"] = eval_bucketed_bf16(time.perf_counter())
    for fam in FAMILIES:
        by_path[f"eval_bucketed_{fam}"] = eval_bucketed_family(
            time.perf_counter(), fam)
    by_path["bucketed_replay_vs_eager"] = bucketed_replay_check(
        time.perf_counter(), ev)

    # 7) kernels line, then the device line
    kernels = []
    for key in K.launches:
        name = key.removesuffix("_bf16")
        rs = checks[key]
        first = rs[0]
        entry = {
            "name": key, "route": "cuda",
            "source": (FWD_BF16_SOURCE if key in ("decode_int_fwd_bf16",
                                                  "decode_window_fwd_bf16")
                       else SOURCES[name]),
            "kernel": DEVICE_KERNEL[key],
            "replaces": REPLACES[name],
            "dtype": "bfloat16" if key.endswith("_bf16") else "float32",
            "launches": sum(c[key] for c in by_path.values()),
            "launches_by_path": {p: c[key] for p, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in
                               rs + checks.get(f"{key}_train", [])),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "shape": first["shape"],
            "achieved_tflops": first["achieved_tflops"]}
        keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "achieved_tflops", "max_abs_err", "ms_by_device_kernel")
        if key.endswith("_bf16"):
            keys += ("err_vs_fp32_chain",)
            entry["err_vs_fp32_chain"] = first["err_vs_fp32_chain"]
        else:
            keys += ("bound_ffma_ms",)
            entry["bound_ffma_ms"] = first["bound_ffma_ms"]
        entry["train_shapes"] = [
            {k: r[k] for k in keys}
            for r in (checks[f"{key}_train"] if name in FWD else rs)]
        if name in FWD:
            entry["eval_shapes"] = [{k: r[k] for k in keys} for r in rs]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

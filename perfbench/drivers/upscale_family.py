"""Single-image upscaling traffic over a model family of its own
(``"kind": "upscale_family"``): one client in a closed loop.

The traffic file holds what ``drivers/upscale.py`` reads, and the
requests, their timing, the pool of images, the sample of kept outputs
and the number compared (``max_abs_gap``) are that driver's. What belongs
to the family comes from the configuration's ``reference`` key, ``<ref>``:
the plain reference ``reference/<ref>.py`` (``param_spec`` and
``predict``) and the counts ``counts_<ref>.py`` (``predict_flops`` and
``decoder_call``). The seeded weights are ``weights.py``'s draw, U(-1 /
sqrt(fan_in), 1 / sqrt(fan_in)) from one ``torch.rand`` on the device, over
the reference's ``param_spec``.

The traced stretch (``userstretch.UserStretch``) records the program's
spans besides CUDA. Where the program's module of the family
(``tpu_diinn_torch.nn.<arch>``) keeps counters (``chunks`` and
``corner_queries``, with ``reset_counters``), the window's are checked
against its requests' shapes, and a disagreement fails the run; a program
without them is not checked. The encoder conv's launches a request
(``kernels/encoder_conv.launches``) are logged where the program has them.
"""

from __future__ import annotations

import importlib
import math
import time
from typing import Dict

import numpy as np
import torch

from perfbench import counts
from perfbench.drivers.common import (Context, Record, device_name, free,
                                      peak_memory, program_tree,
                                      reference_mode, window_loop)
from perfbench.drivers.upscale import Sample, make_images, out_size, schedule
from perfbench.reference.precision import Rounding
from perfbench.userstretch import UserStretch


def reference(config: dict):
    name = config["reference"]
    return importlib.import_module(f"perfbench.reference.{name}")


def family_counts(config: dict):
    return importlib.import_module(f"perfbench.counts_{config['reference']}")


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded draw of ``weights.py`` over the family's ``param_spec``."""
    spec = reference(config).param_spec(config)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, fan_in in spec:
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(fan_in)
        out[name] = ((u[at:at + n] * 2 - 1) * bound).view(shape)
        at += n
    return out


def _program_module(name: str):
    """``tpu_diinn_torch.<name>`` where the program has it, else None."""
    try:
        return importlib.import_module(f"tpu_diinn_torch.{name}")
    except ImportError:
        return None


def build(ctx: Context):
    """(request, weights, images), as ``upscale.build`` with the family's
    weights."""
    from tpu_diinn_torch.config.config import load_config
    from tpu_diinn_torch.train import loop

    tr, dev = ctx.traffic, ctx.device
    ctx.mark("imported")
    cfg = load_config(program_tree(ctx, eval_bsize=tr["eval_bsize"]))
    task = loop.build_task(cfg, device=dev)
    ctx.mark("task built")
    weights = make_weights(ctx.config, ctx.seed, dev)
    task.net.load_state_dict(weights, strict=True)
    if ctx.plant is not None:
        ctx.plant(task)
    images = make_images(tr, ctx.seed)
    ctx.mark("weights and images made")

    def request(img: int, scale: float) -> np.ndarray:
        x = torch.from_numpy(images[img]).to(dev)
        return task.predict(x, out_size(tr, scale)).float().cpu().numpy()
    return request, weights, images


class Counters:
    """The program's decode counters of the family, where it has them."""

    def __init__(self, config: dict):
        arch = config["program"]["model"]["arch"]
        mod = _program_module(f"nn.{arch}")
        self.mod = mod if hasattr(mod, "reset_counters") else None
        self.conv = _program_module("kernels.encoder_conv")
        self.conv_at = 0

    def reset(self) -> None:
        if self.mod is not None:
            self.mod.reset_counters()
        if self.conv is not None:
            self.conv_at = self.conv.launches

    def check(self, ctx: Context, scales) -> None:
        """Raises where the counters disagree with the requests' shapes."""
        tr = ctx.traffic
        if self.conv is not None and scales:
            ctx.log(f"[perfbench] encoder conv launches a request: "
                    f"{(self.conv.launches - self.conv_at) / len(scales)}")
        if self.mod is None:
            return
        want_chunks = want_queries = 0
        for s in scales:
            h, w = out_size(tr, s)
            want_chunks += -(-w // max(1, tr["eval_bsize"] // h))
            want_queries += 4 * h * w
        got = (self.mod.chunks, self.mod.corner_queries)
        ctx.log(f"[perfbench] decode counters {got}, from the shapes "
                f"{(want_chunks, want_queries)}")
        if got != (want_chunks, want_queries):
            raise RuntimeError(f"the program's decode counters {got} differ "
                               f"from its requests' shapes "
                               f"{(want_chunks, want_queries)}")


def run(ctx: Context) -> Record:
    tr, dev = ctx.traffic, ctx.device
    request, weights, images = build(ctx)
    at = schedule(tr, ctx.seed)
    with torch.inference_mode():
        for k in range(tr["warmup_rounds"]):
            for s in tr["scales"]:
                request(0, s)
            ctx.mark(f"warm-up round {k + 1}")
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    stretch = UserStretch(ctx.trace, tr["trace_start"], tr["trace_requests"],
                          ctx.sync)
    sample = Sample(tr["checked_per_scale"], ctx.seed)
    counters = Counters(ctx.config)
    counters.reset()
    items, failed = [], 0

    def body(i: int) -> None:
        nonlocal failed
        img, scale = at(i)
        t0 = time.perf_counter()
        try:
            out = request(img, scale)
        except Exception as exc:  # a failed request counts, the loop goes on
            failed += 1
            ctx.log(f"[perfbench] request {i} (x{scale}) failed: {exc!r}")
            return
        items.append({"latency_s": time.perf_counter() - t0,
                      "pixels": out.shape[1] * out.shape[2], "scale": scale})
        sample.offer(scale, (img, scale, out))

    with torch.inference_mode():
        n, window_s = window_loop(ctx, stretch, body)
    peak = peak_memory(dev)
    del request, body
    free(dev)
    if failed == 0:
        counters.check(ctx, [at(i)[1] for i in range(n)])

    kept = sample.items()
    gap = max_gap(ctx, weights, images, kept)
    name = device_name(dev)
    rec = Record(setup_s=setup_s, window_s=window_s, items=items,
                 attempted=n, failed=failed, memory_peak_bytes=peak,
                 checks={"max_abs_gap": gap}, trace=stretch.trace)
    if stretch.trace is not None:
        ctx.log(f"[perfbench] traced stretch: {len(stretch.trace.host)} "
                f"host events, {len(stretch.trace.device)} device")
    if dev.type == "cuda":
        fc = family_counts(ctx.config)
        traced = [at(i)[1] for i in range(tr["trace_start"], tr["trace_start"]
                                          + tr["trace_requests"])]
        rec.peak_flops = counts.peak_flops(name, tr["dtype"])
        rec.stretch_flops = sum(fc.predict_flops(
            ctx.config, tr["lr_hw"], out_size(tr, s)) for s in traced)
        rec.stretch_decoder_least_s = sum(counts.least_seconds(
            fc.decoder_call(ctx.config, 1, tr["lr_hw"], out_size(tr, s)),
            name, tr["dtype"]) for s in traced)
    ctx.log(f"[perfbench] checked {len(kept)} requests: "
            f"{sorted((s, sample.seen[s]) for s in sample.seen)} seen")
    return rec


def reference_outputs(ctx: Context, weights, images, kept,
                      precision: str = "fp32"):
    """The family reference's output of each kept (image, scale, _)
    request."""
    reference_mode()
    rnd = Rounding(precision)
    ref = reference(ctx.config)
    for img, scale, _ in kept:
        x = torch.from_numpy(images[img]).to(ctx.device)
        yield ref.predict(weights, ctx.config, x, out_size(ctx.traffic, scale),
                          rnd, block=ctx.traffic["reference_block"])


def max_gap(ctx: Context, weights, images, kept, precision="fp32") -> float:
    """The largest |program - reference| over every value of the kept
    outputs (inf where none was kept), as ``upscale.max_gap``."""
    if not kept:
        return float("inf")
    worst = 0.0
    for (_, _, out), want in zip(kept, reference_outputs(
            ctx, weights, images, kept, precision)):
        d = (torch.from_numpy(out).to(want.device) - want).abs()
        if not bool(torch.isfinite(d).all()):
            return float("inf")
        worst = max(worst, float(d.max()))
    return worst

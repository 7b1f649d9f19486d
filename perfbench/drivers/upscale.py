"""Single-image upscaling traffic (``"kind": "upscale"``): one client in a
closed loop.

Reads from the traffic file: ``dtype`` (the program's compute dtype),
``lr_hw`` (the LR image's height and width), ``scales``, ``images`` (a
pool of distinct seeded LR images), ``eval_bsize`` (the program's decode
chunk bound), ``warmup_rounds``, ``checked_per_scale``, the traced
stretch (``trace_start``, ``trace_requests``) and ``reference_block``
(HR queries a block).

Request i takes pool image i mod ``images`` and a scale from a seeded
order in which every block of len(scales) requests holds each scale once,
so that every seed sends the same sizes in another order. The output is
(round(H s), round(W s)). A request is timed from the hand-over of the
host array to the host array of its output: the array moved to the
device, ``SRTask.predict`` (from ``loop.build_task``) under
``torch.inference_mode()``, the output moved back.

Set-up builds the task, loads the seeded weights and warms every scale
``warmup_rounds`` times. The window keeps ``checked_per_scale`` outputs
of each scale, a uniform sample of the scale's requests drawn from the
seed (reservoir sampling); once it is closed and the program freed, the
reference decodes each sampled request, and the number compared is
``max_abs_gap``, the largest absolute gap of an output value to the
reference's.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from perfbench import counts
from perfbench.drivers.common import (Context, Record, device_name, free,
                                      peak_memory, program_tree,
                                      reference_mode, window_loop)
from perfbench.reference import diinn as ref
from perfbench.reference.precision import Rounding
from perfbench.trace import Stretch
from perfbench.weights import make_weights


def make_images(traffic: dict, seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng([seed, 1])
    h, w = traffic["lr_hw"]
    return [rng.random((1, h, w, 3), dtype=np.float32)
            for _ in range(traffic["images"])]


def schedule(traffic: dict, seed: int):
    """request index -> (image index, scale)."""
    rng = np.random.default_rng([seed, 2])
    scales = list(traffic["scales"])
    blocks: List[List[float]] = []

    def at(i: int) -> Tuple[int, float]:
        while len(blocks) <= i // len(scales):
            blocks.append([scales[j] for j in rng.permutation(len(scales))])
        return i % traffic["images"], blocks[i // len(scales)][
            i % len(scales)]
    return at


def out_size(traffic: dict, scale: float) -> Tuple[int, int]:
    h, w = traffic["lr_hw"]
    return round(h * scale), round(w * scale)


class Sample:
    """A seeded uniform sample of ``k`` requests of each scale."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 3])
        self.seen: dict = {}
        self.kept: dict = {}

    def offer(self, scale, item) -> None:
        n = self.seen.get(scale, 0)
        self.seen[scale] = n + 1
        kept = self.kept.setdefault(scale, [])
        if n < self.k:
            kept.append(item)
        else:
            j = int(self.rng.integers(0, n + 1))
            if j < self.k:
                kept[j] = item

    def items(self):
        return [it for s in sorted(self.kept) for it in self.kept[s]]


def build(ctx: Context):
    """(request, weights, images): the program's task with the seeded
    weights behind ``request(image, scale)``, which moves the image to
    the device, predicts and returns the output as a host array."""
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

    stretch = Stretch(ctx.trace, tr["trace_start"], tr["trace_requests"],
                      ctx.sync)
    sample = Sample(tr["checked_per_scale"], ctx.seed)
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

    kept = sample.items()
    gap = max_gap(ctx, weights, images, kept)
    name = device_name(dev)
    rec = Record(setup_s=setup_s, window_s=window_s, items=items,
                 attempted=n, failed=failed, memory_peak_bytes=peak,
                 checks={"max_abs_gap": gap}, trace=stretch.trace)
    if dev.type == "cuda":
        traced = [at(i)[1] for i in range(tr["trace_start"], tr["trace_start"]
                                          + tr["trace_requests"])]
        rec.peak_flops = counts.peak_flops(name, tr["dtype"])
        rec.stretch_flops = sum(counts.predict_flops(
            ctx.config, tr["lr_hw"], out_size(tr, s)) for s in traced)
        rec.stretch_decoder_least_s = sum(counts.least_seconds(
            counts.decoder_call(ctx.config, tr["dtype"], 1, tr["lr_hw"],
                                out_size(tr, s), False), name, tr["dtype"])
            for s in traced)
    ctx.log(f"[perfbench] checked {len(kept)} requests: "
            f"{sorted((s, sample.seen[s]) for s in sample.seen)} seen")
    return rec


def reference_outputs(ctx: Context, weights, images, kept,
                      precision: str = "fp32"):
    """The reference's output of each kept (image, scale, _) request."""
    reference_mode()
    rnd = Rounding(precision)
    for img, scale, _ in kept:
        x = torch.from_numpy(images[img]).to(ctx.device)
        yield ref.predict(weights, ctx.config, x, out_size(ctx.traffic, scale),
                          rnd, block=ctx.traffic["reference_block"])


def max_gap(ctx: Context, weights, images, kept, precision="fp32") -> float:
    """The largest |program - reference| over every value of the kept
    outputs (inf where none was kept)."""
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

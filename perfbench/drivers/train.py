"""Training traffic (``"kind": "train"``): a closed loop of training steps.

Reads from the traffic file: ``dtype`` (the program's compute dtype),
``batch`` LR patches of ``patch`` pixels at every scale of ``scales``
per step, a ``pool`` of distinct seeded batches in pinned host memory
that the steps cycle through, ``lr`` and ``steps_per_epoch`` (the
learning-rate schedule), ``warmup_steps``, the traced stretch
(``trace_start``, ``trace_steps``) and the reference's blocks
(``reference_block`` HR queries, ``reference_image_block`` images).

Set-up builds one training state (``loop.init_state``), loads the seeded
weights, and drives it through its first three steps on batches 0-2
through the window's own call and feed (``loop.to_device`` of a pooled
batch, then the step of ``loop.make_train_step``), reading after step 1
the first gradient as Adam holds it (its first moment over 1 - beta1)
and the prediction that step 1's loss took, and after step 3 each
parameter's change. Then ``warmup_steps`` more, and the window: steps
until the seconds are over, one synchronise at its end. Once the window
is closed and the program's state freed, the reference follows the
first three steps from the same weights and batches, and the numbers
read are

- ``loss_gap``: the largest relative gap of the three steps' losses;
- ``grad_norm_gap``: the worst leaf's gap of the first gradient's norm;
- ``change_norm_gap``: the worst leaf's gap of the norm of its change
  over the three steps, leaving out leaves whose reference gradient norm
  is under a thousandth of the median leaf's (they move by round-off);
- ``pred_gap``: the first step's prediction, every scale's decoder
  output as the program's loss took it, against the reference's: the
  norm of their difference over the norm of the reference's;
- ``grad_norm_gap_median``: the first gradient's norm gap of the median
  leaf, a steadier reading than the worst leaf's.

Each norm gap is measured against the larger of the reference's norm of
that leaf and of the median leaf. A cell compares the numbers that its
limits file names.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import counts
from perfbench.drivers.common import (Context, Record, device_name, free,
                                      leaf_gap, peak_memory, program_tree,
                                      reference_mode, window_loop)
from perfbench.reference import diinn as ref
from perfbench.reference.precision import Rounding
from perfbench.trace import Stretch
from perfbench.weights import make_weights

CHECKED_STEPS = 3


def make_pool(traffic: dict, seed: int, pin: bool) -> List[dict]:
    """``pool`` batches {scale: (lr, hr)} of seeded uniform [0, 1) float32
    NHWC arrays (views of pinned tensors when ``pin``)."""
    rng = np.random.default_rng([seed, 1])
    b, p = traffic["batch"], traffic["patch"]
    pool = []
    for _ in range(traffic["pool"]):
        batch = {}
        for s in traffic["scales"]:
            side = round(p * s)
            pair = []
            for shape in ((b, p, p, 3), (b, side, side, 3)):
                t = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
                t.numpy()[...] = rng.random(shape, dtype=np.float32)
                pair.append(t.numpy())
            batch[s] = tuple(pair)
        pool.append(batch)
    return pool


def hr_pixels(traffic: dict) -> int:
    return traffic["batch"] * sum(round(traffic["patch"] * s) ** 2
                                  for s in traffic["scales"])


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([tensors[k].double().norm() for k in names]).tolist()
    return dict(zip(names, vals))


def _keep_preds(net, kept: list):
    """Hooks the program's decoder so that it keeps a float32 host copy of
    each prediction it makes (the normalized output that the loss takes)
    in ``kept``; returns the hook's handle."""
    def hook(module, args, out):
        kept.append(out.detach().float().cpu())
    return net.decoder.register_forward_hook(hook)


def setup(ctx: Context) -> dict:
    """The program's training state with the seeded weights, driven through
    its first three steps; its ``step``, ``feed`` (batch k of the pool,
    copied in), the ``weights``, the ``pool`` and the program's
    ``readings`` (``losses``; ``grad_norms``, the first gradient's;
    ``pred``, step 1's predictions; ``change``, the change norms)."""
    from tpu_diinn_torch.config.config import load_config
    from tpu_diinn_torch.train import loop

    tr, dev = ctx.traffic, ctx.device
    ctx.mark("imported")
    cfg = load_config(program_tree(ctx, lr=tr["lr"]))
    state = loop.init_state(cfg, tr["steps_per_epoch"], device=dev)
    ctx.mark("training state built")
    weights = make_weights(ctx.config, ctx.seed, dev)
    state.task.net.load_state_dict(weights, strict=True)
    named = dict(state.task.net.named_parameters())
    if ctx.plant is not None:
        ctx.plant(state)
    step = loop.make_train_step(state)
    pool = make_pool(tr, ctx.seed, pin=dev.type == "cuda")
    ctx.mark("weights and batches made")

    def feed(k: int):
        return loop.to_device(pool[k % len(pool)], dev)

    readings = {"losses": [], "pred": []}
    hook = _keep_preds(state.task.net, readings["pred"])
    for k in range(CHECKED_STEPS):
        readings["losses"].append(float(step(feed(k))["loss"]))
        if k == 0:
            hook.remove()
            ctx.mark("first step")
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            held = state.optimizer.state
            readings["grad_norms"] = {n: v / (1 - beta1) for n, v in _norms(
                {n: held[p]["exp_avg"] if p in held else torch.zeros_like(p)
                 for n, p in named.items()}).items()}
    readings["change"] = _norms({n: p.detach() - weights[n]
                                 for n, p in named.items()})
    return {"step": step, "feed": feed, "weights": weights, "pool": pool,
            "readings": readings}


def run(ctx: Context) -> Record:
    tr, dev = ctx.traffic, ctx.device
    prog = setup(ctx)
    step, feed = prog["step"], prog["feed"]
    first = CHECKED_STEPS
    for k in range(tr["warmup_steps"]):
        step(feed(first + k))
    first += tr["warmup_steps"]
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    stretch = Stretch(ctx.trace, tr["trace_start"], tr["trace_steps"],
                      ctx.sync)
    window_losses = []

    def body(i: int) -> None:
        window_losses.append(step(feed(first + i))["loss"])

    n, window_s = window_loop(ctx, stretch, body)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    peak = peak_memory(dev)
    weights, pool, readings = prog["weights"], prog["pool"], prog["readings"]
    del prog, step, feed, body, window_losses
    free(dev)

    checks = compare(ctx, weights, pool, readings)
    name = device_name(dev)
    rec = Record(setup_s=setup_s, window_s=window_s,
                 items=[{"pixels": hr_pixels(tr)}] * n, attempted=n,
                 failed=failed, memory_peak_bytes=peak, checks=checks,
                 trace=stretch.trace)
    if dev.type == "cuda":
        rec.peak_flops = counts.peak_flops(name, tr["dtype"])
        rec.stretch_flops = tr["trace_steps"] * counts.train_step_flops(
            ctx.config, tr["batch"], tr["patch"], tr["scales"])
        rec.stretch_decoder_least_s = tr["trace_steps"] * sum(
            counts.least_seconds(counts.decoder_call(
                ctx.config, tr["dtype"], tr["batch"],
                (tr["patch"], tr["patch"]), (round(tr["patch"] * s),) * 2,
                backward), name, tr["dtype"])
            for s in tr["scales"] for backward in (False, True))
    return rec


def reference_steps(ctx: Context, weights, pool, precision: str = "fp32"
                    ) -> dict:
    """The reference's first three steps from ``weights`` on pool batches
    0-2: the readings of ``setup``."""
    tr, dev = ctx.traffic, ctx.device
    reference_mode()
    rnd = Rounding(precision)
    params = {k: v.detach().clone() for k, v in weights.items()}
    adam = ref.Adam(params, tr["lr"])
    out = {"losses": [], "pred": []}
    for k in range(CHECKED_STEPS):
        batch = [(torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev))
                 for lr, hr in pool[k].values()]
        loss, grads = ref.loss_and_grads(
            params, ctx.config, batch, rnd, block=tr["reference_block"],
            image_block=tr["reference_image_block"],
            preds=out["pred"] if k == 0 else None)
        out["losses"].append(loss)
        if k == 0:
            out["grad_norms"] = _norms(grads)
        adam.step(params, grads)
        del grads, batch
    out["change"] = _norms({k: params[k] - weights[k] for k in params})
    return out


def _median_gap(program: Dict[str, float], reference: Dict[str, float],
                leaves: List[str]) -> float:
    """The median over ``leaves`` of the per-leaf gap of ``leaf_gap``."""
    median = statistics.median(reference.values())
    return statistics.median(abs(program[k] - reference[k])
                             / max(reference[k], median) for k in leaves)


def _pred_gap(program: List[torch.Tensor], reference: List[torch.Tensor]
              ) -> float:
    """Norm of the predictions' difference over the reference's norm. A
    prediction of fewer rows than the reference's counts its missing rows
    as 0."""
    diff = ref_sq = 0.0
    for p, r in zip(program, reference):
        full = torch.zeros_like(r)
        full[:p.shape[0]] = p.to(r.device)
        diff += float((full.double() - r.double()).pow(2).sum())
        ref_sq += float(r.double().pow(2).sum())
    return (diff / ref_sq) ** 0.5


def gaps(program: dict, reference: dict) -> Dict[str, float]:
    """The numbers compared, from the readings of the program and of the
    reference, with the worst leaves in ``worst``."""
    rg, pg = reference["grad_norms"], program["grad_norms"]
    median = statistics.median(rg.values())
    moving = [k for k in rg if rg[k] >= 1e-3 * median]
    grad = leaf_gap(pg, rg)
    change = leaf_gap(program["change"], reference["change"], moving)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(program["losses"], reference["losses"])),
            "grad_norm_gap": grad[0], "change_norm_gap": change[0],
            "pred_gap": _pred_gap(program["pred"], reference["pred"]),
            "grad_norm_gap_median": _median_gap(pg, rg, list(rg)),
            "worst": {"grad": grad[1], "change": change[1]}}


def compare(ctx: Context, weights, pool, readings) -> Dict[str, float]:
    reference = reference_steps(ctx, weights, pool)
    out = gaps(readings, reference)
    ctx.log(f"[perfbench] losses program {readings['losses']} reference "
            f"{reference['losses']}; worst leaves {out.pop('worst')}")
    return out

"""Data-parallel training traffic (``"kind": "train_ddp"``): a closed loop of
training steps on ``ranks`` processes, one card each, the gradients summed
over them in one all-reduce a step.

Reads from the traffic file what ``drivers/train.py`` reads, with
``batch`` the LR patches of each rank at every scale, and ``ranks`` (the
processes), ``threads`` (torch's host threads in each) and
``stop_margin`` (below). Each rank's ``pool`` of batches is seeded by
(seed, rank); the global batch of step k is the ranks' batches k,
concatenated in rank order.

The ranks are the program's ``parallel/launch.RankPool`` (NCCL on the
cards, gloo on the CPU), each bound to an equal, contiguous share of the
host's cores (``bind_cores``), as a multi-card job places its ranks: the
host sets the pace of these steps (on four H100s of one 32-core host
the rate spread 14% from run to run with the ranks left to wander over
the cores, 8% bound). Each rank runs ``loop.init_state``, loads the
seeded weights (rank 0's broadcast, as the trainer starts), and steps with
``loop.make_train_step(state, mesh=make_mesh(data=ranks))``, TF32 off. As
``drivers/train.py`` does, it drives its first three steps on batches 0-2
through the window's own call and feed, reading (rank 0) the three
global losses, the first gradient as Adam holds it and each parameter's
change, and (every rank) step 1's predictions of its shard; then
``warmup_steps`` more, a barrier, and the window.

The ranks agree on the window's steps without a device synchronisation a
step: once its seconds are over (and the traced stretch has ended), rank 0
publishes "stop before step n + stop_margin", n its next step, in a
``TCPStore`` on the host; every other rank reads the store before each
step, and a rank that finds itself past the stop raises. The rate is the
global HR pixels of the window's steps over rank 0's window, which ends
in a synchronise; the trace is rank 0's, the peak memory the largest
rank's.

Once the ranks are closed, the reference follows three steps on the global
batches from the same weights (``train.reference_steps``), and the numbers
compared are ``train.gaps``' (the predictions of the ranks concatenated in
rank order), and ``rank_param_gap``: the largest |theta_r - theta_0| of
any parameter over the ranks after the window.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from perfbench import counts
from perfbench.drivers import train
from perfbench.drivers.common import (Context, Record, device_name, free,
                                      peak_memory, program_tree,
                                      reference_mode)
from perfbench.trace import Stretch
from perfbench.weights import make_weights

RANK_RUN = "perfbench.drivers.train_ddp:rank_run"
STOP = "stop"


def make_pool(traffic: dict, seed: int, rank: int, pin: bool,
              count: int = None) -> List[dict]:
    """Rank ``rank``'s first ``count`` (default ``pool``) batches {scale:
    (lr, hr)}, seeded uniform [0, 1) float32 NHWC arrays, as
    ``train.make_pool`` makes them from (seed, rank)."""
    rng = np.random.default_rng([seed, 1, rank])
    b, p = traffic["batch"], traffic["patch"]
    pool = []
    for _ in range(traffic["pool"] if count is None else count):
        batch = {}
        for s in traffic["scales"]:
            pair = []
            for shape in ((b, p, p, 3), (b, round(p * s), round(p * s), 3)):
                t = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
                t.numpy()[...] = rng.random(shape, dtype=np.float32)
                pair.append(t.numpy())
            batch[s] = tuple(pair)
        pool.append(batch)
    return pool


def global_batches(traffic: dict, seed: int, count: int) -> List[dict]:
    """The first ``count`` global batches: every rank's, concatenated in
    rank order."""
    pools = [make_pool(traffic, seed, r, False, count)
             for r in range(traffic["ranks"])]
    return [{s: tuple(np.concatenate([p[k][s][i] for p in pools])
                      for i in range(2)) for s in traffic["scales"]}
            for k in range(count)]


def global_traffic(traffic: dict) -> dict:
    return dict(traffic, batch=traffic["batch"] * traffic["ranks"])


@dataclasses.dataclass
class RankSpec:
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device_type: str
    store_port: int
    t_start: float


def _steps(ctx: Context, store, rank: int, margin: int, stretch, step,
           feed, first: int) -> tuple:
    """The window's steps on this rank: (steps, window seconds, losses)."""
    losses, stop, i = [], None, 0
    t0 = time.perf_counter()
    while True:
        if rank == 0:
            if stop is None and not stretch.active and (
                    time.perf_counter() - t0 >= ctx.seconds):
                stop = i + margin
                store.set(STOP, str(stop))
        elif stop is None and store.check([STOP]):
            stop = int(store.get(STOP))
            if i > stop:
                raise RuntimeError(f"rank {rank} is at step {i}, past the "
                                   f"published stop {stop}")
        if stop is not None and i >= stop:
            break
        stretch.begin(i)
        losses.append(step(feed(first + i))["loss"])
        stretch.end(i)
        i += 1
    ctx.sync()
    return i, time.perf_counter() - t0, losses


def bind_cores(rank: int, world: int) -> List[int]:
    """Binds every thread of this process (and so the threads it starts
    later) to the ``rank``-th of ``world`` equal contiguous shares of the
    cores it may run on (all of them where there are fewer cores than
    ranks); returns the share."""
    cores = sorted(os.sched_getaffinity(0))
    mine = cores[rank * len(cores) // world:
                 (rank + 1) * len(cores) // world] or cores
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), mine)
        except OSError:     # a thread that ended meanwhile
            pass
    return mine


def rank_run(spec: RankSpec) -> dict:
    """One rank's part of a run (on every rank of a ``RankPool``)."""
    import torch.distributed as dist
    from tpu_diinn_torch.config.config import load_config
    from tpu_diinn_torch.parallel import mesh as pmesh
    from tpu_diinn_torch.train import loop

    rank, world = dist.get_rank(), dist.get_world_size()
    cores = bind_cores(rank, world)
    dev = pmesh.local_device(spec.device_type)
    ctx = Context(config=spec.config, traffic=spec.traffic, seed=spec.seed,
                  seconds=spec.seconds, trace=spec.trace and rank == 0,
                  device=dev, t_start=spec.t_start)
    if rank:
        ctx.log = lambda msg: None
    tr = ctx.traffic
    reference_mode()
    store = dist.TCPStore("localhost", spec.store_port, world, rank == 0,
                          wait_for_workers=False)
    cfg = load_config(program_tree(ctx, lr=tr["lr"]))
    state = loop.init_state(cfg, tr["steps_per_epoch"], device=dev)
    state.task.net.load_state_dict(make_weights(ctx.config, ctx.seed, dev),
                                   strict=True)
    params = list(state.task.net.parameters())
    for p in params:
        pmesh.broadcast_(p.data)
    named = dict(state.task.net.named_parameters())
    start = {n: p.detach().clone() for n, p in named.items()}
    step = loop.make_train_step(state, mesh=pmesh.make_mesh(data=world))
    pool = make_pool(tr, ctx.seed, rank, pin=dev.type == "cuda")
    ctx.mark(f"{world} ranks: training state and batches made; rank 0 on "
             f"cores {cores}")

    def feed(k: int):
        return loop.to_device(pool[k % len(pool)], dev)

    readings = {"losses": [], "pred": []}
    hook = train._keep_preds(state.task.net, readings["pred"])
    for k in range(train.CHECKED_STEPS):
        readings["losses"].append(float(step(feed(k))["loss"]))
        if k == 0:
            hook.remove()
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            held = state.optimizer.state
            readings["grad_norms"] = {n: v / (1 - beta1) for n, v in
                                      train._norms({
                                          n: held[p]["exp_avg"] if p in held
                                          else torch.zeros_like(p)
                                          for n, p in named.items()}).items()}
    readings["change"] = train._norms({n: p.detach() - start[n]
                                       for n, p in named.items()})
    del start
    first = train.CHECKED_STEPS
    for k in range(tr["warmup_steps"]):
        step(feed(first + k))
    first += tr["warmup_steps"]
    ctx.sync()
    pmesh.barrier()
    t_window = time.perf_counter()

    stretch = Stretch(ctx.trace, tr["trace_start"], tr["trace_steps"],
                      ctx.sync)
    n, window_s, losses = _steps(ctx, store, rank, tr["stop_margin"],
                                 stretch, step, feed, first)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    first_rank = pmesh.broadcast_(flat.clone())
    param_gap = float((flat - first_rank).abs().max())
    out = {"steps": n, "window_s": window_s, "t_window": t_window,
           "failed": failed, "param_gap": param_gap,
           "peak": peak_memory(dev),
           "pred": [t.numpy() for t in readings.pop("pred")],
           "readings": readings if rank == 0 else None,
           "trace": stretch.trace}
    pmesh.barrier()
    return out


def _build_kernels(ctx: Context) -> None:
    """Builds the program's CUDA libraries once, before the ranks load
    them."""
    if ctx.device.type != "cuda":
        return
    from tpu_diinn_torch.kernels import build
    with ThreadPoolExecutor(max_workers=len(build.SOURCES)) as ex:
        for f in [ex.submit(build.build, n) for n in build.SOURCES]:
            f.result()
    ctx.mark("kernels built")


def run(ctx: Context) -> Record:
    from tpu_diinn_torch.parallel.launch import RankPool, free_port

    tr, dev = ctx.traffic, ctx.device
    _build_kernels(ctx)
    spec = RankSpec(config=ctx.config, traffic=tr, seed=ctx.seed,
                    seconds=ctx.seconds, trace=ctx.trace,
                    device_type=dev.type, store_port=free_port(),
                    t_start=ctx.t_start)
    with RankPool(tr["ranks"], device_type=dev.type,
                  threads=tr["threads"]) as pool:
        outs = pool.run(RANK_RUN, spec)
    lead = outs[0]
    if len({o["steps"] for o in outs}) != 1:
        raise RuntimeError(f"the ranks ran {[o['steps'] for o in outs]} "
                           f"steps")
    free(dev)

    readings = dict(lead["readings"])
    readings["pred"] = [torch.from_numpy(np.concatenate(
        [o["pred"][j] for o in outs])) for j in range(len(lead["pred"]))]
    checks = compare(ctx, readings)
    checks["rank_param_gap"] = max(o["param_gap"] for o in outs)
    n = lead["steps"]
    rec = Record(setup_s=lead["t_window"] - ctx.t_start,
                 window_s=lead["window_s"],
                 items=[{"pixels": train.hr_pixels(global_traffic(tr))}] * n,
                 attempted=n, failed=lead["failed"],
                 memory_peak_bytes=max(o["peak"] for o in outs),
                 checks=checks, trace=lead["trace"])
    if dev.type == "cuda":
        name = device_name(dev)
        rec.peak_flops = counts.peak_flops(name, tr["dtype"])
        rec.stretch_flops = tr["trace_steps"] * counts.train_step_flops(
            ctx.config, tr["batch"], tr["patch"], tr["scales"])
    ctx.log(f"[perfbench] {tr['ranks']} ranks, {n} steps each; peak "
            f"memory {[o['peak'] for o in outs]}")
    return rec


def compare(ctx: Context, readings: dict) -> Dict[str, float]:
    """``train.gaps`` of the program's readings against the reference's
    three steps on the global batches."""
    tr = ctx.traffic
    weights = make_weights(ctx.config, ctx.seed, ctx.device)
    gctx = dataclasses.replace(ctx, traffic=global_traffic(tr))
    reference = train.reference_steps(
        gctx, weights, global_batches(tr, ctx.seed, train.CHECKED_STEPS))
    out = train.gaps(readings, reference)
    ctx.log(f"[perfbench] losses program {readings['losses']} reference "
            f"{reference['losses']}; worst leaves {out.pop('worst')}")
    return out

"""The readings the limits of the cells of ``upscale_family`` and
``train_ddp`` traffic are set from, as ``control.py`` gives them for the
other kinds. The benchmark's own runs do not run this.

    python3 perfbench/control_family.py --workload <cell> --seeds 1 2 3 \\
        [--controls 3] [--faults 3] [--out FILE]

``upscale_family``: for every seed, the program's ``max_abs_gap`` on as
many requests as a run compares (``checked_per_scale`` of each scale, in
the traffic's order); for the first ``--controls`` seeds, the family's
reference computed in each of the cell's controls' precisions against the
float32 reference; for the first ``--faults`` seeds, each upscaling fault
of ``faults.py`` planted in the program. ``train_ddp``: the program's
readings come from the benchmark's runs (they need the ranks); here, for
each seed, each control's three reference steps on the global batches
against the float32 reference's (``train.gaps``). One JSON line per reading
on standard output, and in ``--out`` if given.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") !=
                        os.path.dirname(os.path.abspath(__file__))]

import torch  # noqa: E402

from perfbench import faults, harness  # noqa: E402
from perfbench.drivers import train, train_ddp, upscale_family  # noqa: E402
from perfbench.drivers.common import Context, free  # noqa: E402
from perfbench.drivers.upscale import schedule  # noqa: E402
from perfbench.weights import make_weights  # noqa: E402


def family_outputs(ctx: Context, plant=None):
    ctx.plant = plant
    request, weights, images = upscale_family.build(ctx)
    tr = ctx.traffic
    at = schedule(tr, ctx.seed)
    n = tr["checked_per_scale"] * len(tr["scales"])
    with torch.inference_mode():
        kept = [(img, s, request(img, s)) for img, s in map(at, range(n))]
    del request
    free(ctx.device)
    return kept, weights, images


def family_readings(ctx: Context, controls, with_faults: bool):
    kept, weights, images = family_outputs(ctx)
    yield "program", {"max_abs_gap": upscale_family.max_gap(
        ctx, weights, images, kept)}
    for precision in controls:
        low = [(img, s, out.cpu().numpy()) for (img, s, _), out in zip(
            kept, upscale_family.reference_outputs(ctx, weights, images, kept,
                                                   precision))]
        yield f"control_{precision}", {"max_abs_gap": upscale_family.max_gap(
            ctx, weights, images, low)}
    for name, fault in (faults.UPSCALE.items() if with_faults else ()):
        kept, weights, images = family_outputs(ctx, fault)
        yield name, {"max_abs_gap": upscale_family.max_gap(
            ctx, weights, images, kept)}


def ddp_readings(ctx: Context, controls):
    tr = ctx.traffic
    weights = make_weights(ctx.config, ctx.seed, ctx.device)
    batches = train_ddp.global_batches(tr, ctx.seed, train.CHECKED_STEPS)
    gctx = dataclasses.replace(ctx, traffic=train_ddp.global_traffic(tr))
    ref = train.reference_steps(gctx, weights, batches)
    for precision in controls:
        low = train.reference_steps(gctx, weights, batches, precision)
        yield f"control_{precision}", _gaps(low, ref)


def _gaps(program: dict, reference: dict) -> dict:
    out = train.gaps(program, reference)
    out.pop("worst")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench/control_family.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.load_cell(harness.load_benchmark(), args.workload)
    if args.device.startswith("cuda"):
        from tpu_diinn_torch.cli.benchmarks import resolve_device
        device = resolve_device(args.device)
    else:
        device = torch.device(args.device)
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(args.seeds):
            ctx = Context(config=cell.config, traffic=cell.traffic,
                          seed=seed, seconds=0.0, trace=False, device=device,
                          t_start=time.perf_counter())
            controls = cell.controls if i < args.controls else ()
            if cell.traffic["kind"] == "train_ddp":
                found = ddp_readings(ctx, controls)
            else:
                found = family_readings(ctx, controls, i < args.faults)
            for kind, numbers in found:
                line = json.dumps({"workload": cell.name, "seed": seed,
                                   "kind": kind, **numbers})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

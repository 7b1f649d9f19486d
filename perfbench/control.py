"""The readings a cell's limits are set from. The benchmark's own runs do
not run this.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 ... \\
        [--controls 3] [--faults 3] [--out FILE]

For every seed, in one process: the program's numbers against the
reference, as a run compares them (the lower readings). For the first
``--controls`` seeds, each of the cell's controls (its limits file's
``controls``): the reference itself in the program's place, computed in
a precision below the traffic's (for bfloat16 fp8 or int8, for float32
TF32), against the float32 reference (the upper readings). For
the first ``--faults`` seeds, each fault of ``faults.py`` that the
traffic's kind can have, planted in the program. Training needs no
window; upscaling decodes as many requests as a run compares
(``checked_per_scale`` of each scale, in the traffic's order). One JSON
line per reading on standard output, and in ``--out`` if given; a
control's ``kind`` is ``control_<precision>``.
"""

import argparse
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
from perfbench.drivers import train, upscale  # noqa: E402
from perfbench.drivers.common import Context, free  # noqa: E402

def train_readings(ctx: Context, plant=None):
    ctx.plant = plant
    prog = train.setup(ctx)
    out = (prog["readings"], prog["weights"], prog["pool"])
    del prog
    free(ctx.device)
    return out


def upscale_outputs(ctx: Context, plant=None):
    ctx.plant = plant
    request, weights, images = upscale.build(ctx)
    tr = ctx.traffic
    at = upscale.schedule(tr, ctx.seed)
    n = tr["checked_per_scale"] * len(tr["scales"])
    with torch.inference_mode():
        kept = [(img, s, request(img, s)) for img, s in map(at, range(n))]
    del request
    free(ctx.device)
    return kept, weights, images


def readings(ctx: Context, controls, with_faults: bool):
    """(kind, numbers) of one seed; ``controls``: the controls'
    precisions, none for no control."""
    if ctx.traffic["kind"] == "train":
        prog, weights, pool = train_readings(ctx)
        ref = train.reference_steps(ctx, weights, pool)
        yield "program", train.gaps(prog, ref)
        for precision in controls:
            low = train.reference_steps(ctx, weights, pool, precision)
            yield f"control_{precision}", train.gaps(low, ref)
        for name, fault in (faults.TRAIN.items() if with_faults else ()):
            yield name, train.gaps(train_readings(ctx, fault)[0], ref)
        return
    kept, weights, images = upscale_outputs(ctx)
    yield "program", {"max_abs_gap": upscale.max_gap(ctx, weights, images,
                                                     kept)}
    for precision in controls:
        low = [(img, s, out.cpu().numpy()) for (img, s, _), out in zip(
            kept, upscale.reference_outputs(ctx, weights, images, kept,
                                            precision))]
        yield f"control_{precision}", {"max_abs_gap": upscale.max_gap(
            ctx, weights, images, low)}
    for name, fault in (faults.UPSCALE.items() if with_faults else ()):
        kept, weights, images = upscale_outputs(ctx, fault)
        yield name, {"max_abs_gap": upscale.max_gap(ctx, weights, images,
                                                    kept)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench/control.py")
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
            for kind, numbers in readings(
                    ctx, cell.controls if i < args.controls else (),
                    i < args.faults):
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

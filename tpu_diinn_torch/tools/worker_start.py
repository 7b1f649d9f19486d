"""Time ``cli.train`` with its training sample workers started by ``spawn``
and by ``forkserver``, in turns, on one card.

    python3 -m tpu_diinn_torch.tools.worker_start [--steps 120] [--out DIR]

``data/pipeline.py`` forks the workers from a ``forkserver`` that has the
datasets (and so torch) imported; under ``spawn`` each worker is a new
interpreter that imports them itself, and the main module again. Runs
``cli.train``'s ``main`` on the card in a fresh process for each of
spawn, forkserver, forkserver, spawn: the flagship defaults with each
DIV2K image once an epoch (40 steps, so one pool of workers every 40
steps), for ``--steps`` steps, validation on two images after each
epoch, checkpoints and log under ``--out/<i>-<method>``. This module
imports ``cli.train`` at the top, so a worker's import of the main module costs
what it costs under ``python -m tpu_diinn_torch.cli.train``. The kernels
are built before the timed call (the first run builds them; the build is
cached). Each run prints one JSON line: the start method, the seconds of
``main``, the host's waits for each epoch's first batch and the sum of
its waits for the later ones, and the trainer's logged ``steps_per_s``.
The last line gives the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import shutil
import subprocess
import sys
import time
from pathlib import Path

from tpu_diinn_torch.cli import train as train_cli
from tpu_diinn_torch.data import pipeline

METHODS = ("spawn", "forkserver", "forkserver", "spawn")


class _StartMethod:
    """``multiprocessing`` as ``data/pipeline.py`` sees it, with every
    context of one start method."""

    def __init__(self, method: str):
        self.method = method

    def get_context(self, _method=None):
        return multiprocessing.get_context(self.method)


def _waits_timed(train_batches, first: list, later: list):
    """``train_batches`` that appends the host's wait for each epoch's
    first batch to ``first`` and adds its waits for the later ones (and
    for the workers' stop) to ``later[0]``."""
    def gen(*args, **kwargs):
        it = train_batches(*args, **kwargs)
        t0 = time.perf_counter()
        try:
            item = next(it, None)
            first.append(time.perf_counter() - t0)
            while item is not None:
                yield item
                t0 = time.perf_counter()
                item = next(it, None)
                later[0] += time.perf_counter() - t0
        finally:
            t0 = time.perf_counter()
            it.close()
            later[0] += time.perf_counter() - t0
    return gen


def _run(method: str, out: Path, steps: int) -> dict:
    from tpu_diinn_torch.kernels import build
    build.load_all()
    shutil.rmtree(out, ignore_errors=True)
    first, later = [], [0.0]
    pipeline.multiprocessing = _StartMethod(method)
    pipeline.train_batches = _waits_timed(pipeline.train_batches, first,
                                          later)
    t0 = time.perf_counter()
    train_cli.main(["--device", "cuda", "--max-steps", str(steps),
                    "data.trainsets_repeat=1", "trainer.limit_val_images=2",
                    f"trainer.ckpt_dir={out}", f"trainer.log_dir={out}"])
    seconds = time.perf_counter() - t0
    records = [json.loads(ln) for ln in
               (out / "metrics.jsonl").read_text().splitlines()]
    return {"method": method, "main_seconds": seconds,
            "first_batch_seconds": first, "later_batches_seconds": later[0],
            "steps_per_s": [r["steps_per_s"] for r in records
                            if "steps_per_s" in r]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--out", type=Path, default=Path("build/worker_start"))
    ap.add_argument("--one", nargs=2, metavar=("METHOD", "DIR"),
                    help=argparse.SUPPRESS)   # one run, in this process
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(_run(args.one[0], Path(args.one[1]), args.steps)),
              flush=True)
        return 0
    for i, method in enumerate(METHODS):
        out = subprocess.run(
            [sys.executable, "-m", "tpu_diinn_torch.tools.worker_start",
             "--steps", str(args.steps), "--one", method,
             str(args.out / f"{i}-{method}")],
            capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            raise SystemExit(f"run {i} ({method}): exit {out.returncode}")
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

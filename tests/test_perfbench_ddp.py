"""The benchmark's data-parallel training driver (``perfbench/drivers/
train_ddp.py``) on four gloo ranks on the CPU, and the lookup of the
cells this driver and the LIIF driver serve.

The ranks are the program's ``parallel/launch.RankPool`` (spawned, one
torch thread each), at a tiny size (RDN-tiny, hidden 32 x 3, one 8-px
patch a rank at scales 2, 3 and 4) in float32, so that the data-parallel
step is the single-process step to fp32 summation order: the ranks stop on
the same step, every rank holds rank 0's parameters bit for bit after the
window, and the three checked steps read against the plain reference on
the ranks' batches concatenated in rank order within float32 round-off.
"""

import json
import multiprocessing
import os
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.drivers import train_ddp, upscale_family
from perfbench.drivers.common import Context
from perfbench.reference import diinn
from tpu_diinn_torch.parallel.launch import RankPool, free_port

ROOT = Path(__file__).resolve().parents[1]
TINY = {"name": "tiny-rdn",
        "encoder": {"kind": "rdn", "in_channels": 3, "blocks": 2,
                    "convs": 2, "growth": 16, "growth0": 16},
        "decoder": {"mode": 3, "hidden_dims": [32, 32, 32], "init_q": False,
                    "sine": "polynomial", "out_channels": 3},
        "program": {"model": {"arch": "diinn", "encoder": "rdn-tiny",
                              "mode": 3, "init_q": False,
                              "hidden_dims": [32, 32, 32]}}}


def tiny_ctx(seconds: float = 0.5, **traffic) -> Context:
    tr = json.loads((ROOT / "perfbench" / "traffic" / "train-b4x4-x234.json")
                    .read_text())
    tr.update(dtype="float32", batch=1, patch=8, pool=4, threads=1,
              trace_steps=2, reference_block=300, reference_image_block=3)
    tr.update(traffic)
    return Context(config=TINY, traffic=tr, seed=2**31 + 5, seconds=seconds,
                   trace=False, device=torch.device("cpu"),
                   t_start=time.perf_counter())


def test_ranks_stop_together_hold_one_state_and_match_the_reference():
    ctx = tiny_ctx()
    spec = train_ddp.RankSpec(
        config=ctx.config, traffic=ctx.traffic, seed=ctx.seed,
        seconds=ctx.seconds, trace=False, device_type="cpu",
        store_port=free_port(), t_start=ctx.t_start)
    with RankPool(4, threads=1) as pool:
        outs = pool.run(train_ddp.RANK_RUN, spec)
    steps = {o["steps"] for o in outs}
    assert len(steps) == 1 and steps.pop() >= ctx.traffic["stop_margin"]
    assert [o["param_gap"] for o in outs] == [0.0] * 4
    assert outs[0]["readings"] is not None
    assert all(o["readings"] is None for o in outs[1:])
    readings = dict(outs[0]["readings"])
    readings["pred"] = [torch.cat([torch.from_numpy(o["pred"][j])
                                   for o in outs]) for j in range(3)]
    assert [p.shape[0] for p in readings["pred"]] == [4, 4, 4]
    gaps = train_ddp.compare(ctx, readings)
    assert gaps["loss_gap"] <= 1e-6
    assert gaps["grad_norm_gap"] <= 1e-4
    assert gaps["grad_norm_gap_median"] <= 1e-5
    assert gaps["change_norm_gap"] <= 1e-3
    assert gaps["pred_gap"] <= 1e-5


def test_a_run_is_correct_under_the_cells_limits():
    """The driver end to end, judged by ``diinn-rdn.train-ddp4``'s limits:
    every rank's steps counted once, the rate over rank 0's window."""
    bench = harness.load_benchmark()
    cell = harness.load_cell(bench, "diinn-rdn.train-ddp4")
    ctx = tiny_ctx()
    rec = train_ddp.run(ctx)
    assert rec.failed == 0 and rec.attempted >= ctx.traffic["stop_margin"]
    assert rec.checks["rank_param_gap"] == 0.0
    assert rec.setup_s > 0 and rec.window_s >= ctx.seconds
    px = 4 * sum(round(8 * s) ** 2 for s in (2, 3, 4))
    assert rec.items == [{"pixels": px}] * rec.attempted
    out = harness.result(cell, rec, False, ctx.device)
    assert out["correct"] and out["device"]["count"] == 4
    # the host-paced four-card rate spreads too widely for the flagship's
    # bound, so the cell reports the wider-bounded twin
    assert set(out["metrics"]) == {"train_pixels_per_s.edsr", "setup_s"}


def test_global_batches_are_the_ranks_batches_in_rank_order():
    tr = tiny_ctx().traffic
    g = train_ddp.global_batches(tr, 9, 2)
    for r in range(4):
        own = train_ddp.make_pool(tr, 9, r, False, 2)
        for k in range(2):
            for s in tr["scales"]:
                for i in range(2):
                    assert (g[k][s][i][r:r + 1] == own[k][s][i]).all()
    assert not (train_ddp.make_pool(tr, 9, 0, False, 1)[0][2][0]
                == train_ddp.make_pool(tr, 9, 1, False, 1)[0][2][0]).all()


@pytest.mark.parametrize("name,kind,metrics", [
    ("liif-rdn.upscale", "upscale_family",
     {"idle_share.upscale.liif", "mfu.upscale.liif", "conv_ms.upscale.liif",
      "liif_decoder_roofline.upscale", "idle_in_decoder.upscale.liif",
      "decoder_host_ms.upscale.liif"}),
    ("diinn-rdn.train-ddp4", "train_ddp",
     {"allreduce_ms.train", "idle_share.train.ddp4", "mfu.train.ddp4"})])
def test_the_new_cells_find_their_files(name, kind, metrics):
    bench = harness.load_benchmark()
    cell = harness.load_cell(bench, name)
    assert cell.traffic["kind"] == kind
    assert callable(harness.load_driver(kind))
    assert {m["name"] for m in cell.per_layer} == metrics
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_reader(m["name"]))
    assert cell.controls and "max_abs_gap" in cell.limits or \
        "rank_param_gap" in cell.limits
    if kind == "upscale_family":
        spec = upscale_family.reference(cell.config).param_spec(cell.config)
        assert upscale_family.family_counts(cell.config).predict_flops
        assert cell.chips == 1
    else:
        spec = diinn.param_spec(cell.config)
        assert cell.chips == cell.traffic["ranks"] == 4
    assert sum(torch.Size(s).numel() for _, s, _ in spec) > 2e7


def test_ranks_take_equal_disjoint_shares_of_the_cores():
    """``bind_cores`` in four spawned processes: each rank's share is its
    contiguous quarter of the cores (all of them where fewer than four)."""
    cores = sorted(os.sched_getaffinity(0))
    with multiprocessing.get_context("spawn").Pool(
            4, maxtasksperchild=1) as pool:
        shares = pool.starmap(_bound, [(r, 4) for r in range(4)])
    for r, share in enumerate(shares):
        want = cores[r * len(cores) // 4:(r + 1) * len(cores) // 4]
        assert share == (want or cores)


def _bound(rank: int, world: int) -> list:
    got = train_ddp.bind_cores(rank, world)
    assert sorted(os.sched_getaffinity(0)) == got
    return got

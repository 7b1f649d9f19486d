"""Training and eval loops: the multi-scale train step, the epoch loop,
validation, benchmark metrics.

Counterpart of ``tpu_diinn/train/loop.py`` on one device, run eagerly:
PyTorch compiles nothing here, so the JAX package's per-shape jit cache
has no counterpart; its bucketed static-shape eval is
``train/bucketed.BucketedEval`` (one CUDA graph per bucket), which
``test_metrics`` takes as its ``evaluator``. A training step
is forward, multi-scale L1, backward (through the fused decoder's backward
kernels on a card), the global gradient norm and one Adam update, with
the learning rate keyed on the global step. Each epoch ends with a
full-image validation (loss and div2k-protocol PSNR per scale) and the
best/last checkpoints, each with the training state beside it; a run
resumes from one (``trainer.resume``), traces a window of steps
(``trainer.profile_dir``) or raises on a non-finite value
(``trainer.debug_nans``) as the JAX trainer does.

Under ``torch.distributed`` (``parallel/mesh.py``) the trainer lays the
ranks out as the ('data', 'space') mesh of ``trainer.mesh_data`` x
``trainer.mesh_space``, which must use every rank. Each rank loads its
'data' shard of every global batch (``batch_size / data`` samples; the
ranks of one space group load the same ones); with ``space > 1`` each
rank decodes and takes the L1 loss over its own clamped column stripe of
every scale's HR grid (``SRTask.stripe_loss``), the encoder and the
stacked LR conv replicated within the space group. Each rank's loss is
its share of the global loss, and the gradients are summed over every
rank in one all-reduce, so the step is the unsharded step's (to fp32
summation order). The parameters start equal on every rank (rank 0's
are broadcast), Adam updates them alike, only rank 0 validates, logs and
writes checkpoints, every rank restores, and a barrier ends each epoch.

Every entry point runs on the card (``device="cuda"``) unless the caller
asks for the CPU, as the JAX package runs on its default device.
``model.dtype=bfloat16`` is the JAX package's bf16 mode: the net computes
in bf16 (``make_net(dtype=...)``), its parameters, their gradients and
Adam's state stay float32, and the L1 loss of the bf16 prediction against
the float32 target is float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu_diinn_torch.config.config import Config, to_dict
from tpu_diinn_torch.data import datasets as ds
from tpu_diinn_torch.data import pipeline
from tpu_diinn_torch.nn.registry import make_net
from tpu_diinn_torch.parallel import mesh as pmesh
from tpu_diinn_torch.train import metrics as M
from tpu_diinn_torch.train import profiling
from tpu_diinn_torch.train.checkpoint import (CheckpointManager,
                                              load_optimizer_arrays,
                                              state_dict_from_jax)
from tpu_diinn_torch.train.logging import MetricsLogger
from tpu_diinn_torch.train.optim import make_optimizer, restore_schedule
from tpu_diinn_torch.train.task import SRTask


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_task(cfg: Config, *, device="cuda",
               generator: Optional[torch.Generator] = None) -> SRTask:
    """The net of ``cfg.model`` on ``device``: float32 parameters, computing
    in ``model.dtype`` (float32 or bfloat16)."""
    m = cfg.model
    if m.dtype not in DTYPES:
        raise ValueError(f"model.dtype={m.dtype!r}: one of {list(DTYPES)}")
    net = make_net(m.arch, mode=m.mode, init_q=m.init_q,
                   encoder_spec=m.encoder, hidden_dims=m.hidden_dims,
                   use_fused=m.use_fused, generator=generator,
                   dtype=DTYPES[m.dtype])
    return SRTask(net=net.to(device), eval_bsize=m.eval_bsize)


@dataclasses.dataclass
class TrainState:
    task: SRTask
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def init_state(cfg: Config, steps_per_epoch: int, *, device="cuda",
               params: Optional[Dict[str, np.ndarray]] = None
               ) -> TrainState:
    """The net (initialised from ``torch.Generator().manual_seed(cfg.
    seed)``, or loaded from flat JAX-path ``params`` as
    ``load_params_npz`` returns them), Adam and its schedule, at step 0."""
    task = build_task(cfg, device=device,
                      generator=torch.Generator().manual_seed(cfg.seed))
    if params is not None:
        task.net.load_state_dict(state_dict_from_jax(params), strict=True)
    opt, sched = make_optimizer(task.net.parameters(), cfg.model.lr,
                                steps_per_epoch, cfg.model.lr_step,
                                cfg.model.lr_gamma, cfg.trainer.max_epochs)
    return TrainState(task=task, optimizer=opt, scheduler=sched)


def apply_update(state: TrainState) -> None:
    """One Adam update at the current step's learning rate."""
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


def make_train_step(state: TrainState, debug_nans: bool = False,
                    mesh: Optional[pmesh.Mesh] = None):
    """``step(batch) -> {"loss", "grad_norm"}`` (device scalars) for a
    batch {scale: (lr, hr)} of tensors on the net's device. The norm is
    taken over every parameter's gradient, as ``optax.global_norm``. With
    ``debug_nans`` a non-finite loss raises ``FloatingPointError`` before
    the backward and a non-finite gradient norm before the update (each
    check waits for the card); run the step under
    ``profiling.enable_debug_nans`` to have autograd name the operation
    whose gradient is not finite.

    Under a process group, ``mesh`` shards the step: ``batch`` is this
    rank's 'data' shard, the rank takes its 'space' stripe's share of the
    loss (divided by the data size), and the loss and the gradients are
    summed over every rank, so that every rank reports and applies the
    global loss's gradient."""
    params = list(state.task.net.parameters())
    sharded = mesh is not None and torch.distributed.is_initialized()
    if not sharded:
        def local_loss(batch):
            return state.task.train_loss(batch)
    else:
        def local_loss(batch):
            if mesh.space.size > 1:
                loss = state.task.stripe_loss(batch, mesh.space.index,
                                              mesh.space.size)
            else:
                loss = state.task.train_loss(batch)
            return loss / mesh.data.size if mesh.data.size > 1 else loss

    def step(batch) -> Dict[str, torch.Tensor]:
        with profiling.span(f"train_step {state.step + 1}"):
            with profiling.span("step.update"):
                state.optimizer.zero_grad(set_to_none=True)
            with profiling.span("step.forward"):
                loss = local_loss(batch)
            total = (pmesh.all_reduce_sum_(loss.detach().clone()) if sharded
                     else loss.detach())
            if debug_nans:
                profiling.check_finite(state.step + 1, loss=total)
            with profiling.span("step.backward"):
                loss.backward()
            grads = [p.grad for p in params if p.grad is not None]
            if sharded:     # one all-reduce over the flattened gradients
                flat = pmesh.all_reduce_sum_(
                    torch.cat([g.reshape(-1) for g in grads]))
                torch._foreach_copy_(grads, [
                    part.view_as(g) for g, part in
                    zip(grads, flat.split([g.numel() for g in grads]))])
            with profiling.span("step.update"):
                gnorm = torch.stack([g.square().sum()
                                     for g in grads]).sum().sqrt()
                if debug_nans:
                    profiling.check_finite(state.step + 1, grad_norm=gnorm)
                apply_update(state)
            return {"loss": total, "grad_norm": gnorm}

    return step


def restore_state(state: TrainState, ckpt_dir: str) -> dict:
    """Put ``state`` (from ``init_state``) at the ``last`` checkpoint of
    ``ckpt_dir``: the parameters, Adam's state, the global step and the
    learning rate schedule at that step. Returns the checkpoint's meta."""
    flat, meta, arrays, state_meta = CheckpointManager(ckpt_dir).restore()
    net = state.task.net
    net.load_state_dict(state_dict_from_jax(flat), strict=True)
    load_optimizer_arrays(net, state.optimizer, arrays)
    restore_schedule(state.scheduler, state_meta["scheduler_last_epoch"])
    state.step = int(meta["step"])
    return meta


def to_device(batch, device) -> Dict[float, tuple]:
    """A numpy batch {scale: (lr, hr)} as tensors on ``device``."""
    with profiling.span("to_device"):
        return {s: (torch.from_numpy(lr).to(device),
                    torch.from_numpy(hr).to(device))
                for s, (lr, hr) in batch.items()}


def _build_set(cfg: Config, name: str, split: str, *, scales,
               patch_size: int, augment: bool, use_native: bool = True):
    """One dataset from a (name, split) config entry. DIV2K's train images
    split into ``train`` = [0:cut) and ``val`` = [cut:n), cut = 800 when
    all 900 are on disk, else 8/9 of what is (reduced copies keep a
    disjoint divide). Benchmark sets are used whole. ``use_native``: the
    native loader where it built (``data/datasets.py``)."""
    if name == "DIV2K":
        full = ds.SRDatasetDownsample(root=cfg.data.root, name="DIV2K",
                                      split="train", scales=scales,
                                      patch_size=patch_size, augment=augment,
                                      use_native=use_native)
        n = len(full)
        cut = 800 if n >= 900 else (n * 8) // 9
        return ds.Subset(full, range(0, cut) if split == "train"
                         else range(cut, n))
    return ds.SRDatasetDownsample(root=cfg.data.root, name=name, split=split,
                                  scales=scales, patch_size=patch_size,
                                  augment=augment, use_native=use_native)


def make_datasets(cfg: Config, use_native: bool = True):
    """(train, val) from ``cfg.data``: augmented patches of every trainset
    at ``train_scales``, and full images of the first trainset's held-out
    tail; or synthetic images. ``use_native=False`` keeps the numpy path
    even where the native loader built."""
    d = cfg.data
    if d.synthetic:
        train = ds.SyntheticSRDataset(n_images=16, scales=d.train_scales,
                                      patch_size=d.patch_size, seed=cfg.seed)
        val = ds.SyntheticSRDataset(n_images=2, scales=d.train_scales,
                                    patch_size=0, augment=False,
                                    seed=cfg.seed + 1, image_size=96)
        return train, val
    trains = [_build_set(cfg, name, split, scales=d.train_scales,
                         patch_size=d.patch_size, augment=True,
                         use_native=use_native)
              for name, split in d.trainsets]
    train = trains[0] if len(trains) == 1 else ds.ConcatDataset(trains)
    val = _build_set(cfg, d.trainsets[0][0], "val", scales=d.train_scales,
                     patch_size=0, augment=False, use_native=use_native)
    return train, val


def make_test_datasets(cfg: Config) -> Dict[str, Any]:
    """Test sets from ``cfg.data.testsets`` at ``cfg.data.test_scales``:
    ("DIV2K", "train") is the DIV2K val tail, ("benchmark", <Set>) a
    benchmark set."""
    out: Dict[str, Any] = {}
    for name, split in cfg.data.testsets:
        key = split if name == "benchmark" else name
        out[key] = _build_set(cfg, name, "val" if name == "DIV2K" else split,
                              scales=cfg.data.test_scales, patch_size=0,
                              augment=False)
    return out


class WeightedMean:
    """Batch-size-weighted mean: sum(v_i * B_i) / sum(B_i)."""

    def __init__(self):
        self.num = 0.0
        self.den = 0.0

    def update(self, value: float, weight: float = 1.0) -> None:
        self.num += float(value) * float(weight)
        self.den += float(weight)

    def compute(self) -> float:
        return self.num / self.den if self.den else float("nan")


@torch.no_grad()
def validate(task: SRTask, dataset, *, max_images: Optional[int] = None,
             device="cuda") -> Dict[str, float]:
    """Full-image validation: ``val_loss`` (per image, the mean over its
    scales) and ``val_psnr_x{s}`` (div2k protocol), averaged over
    images; the decode is chunked at ``task.eval_bsize`` queries."""
    losses, psnrs = WeightedMean(), {}
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    for _, batch in pipeline.eval_batches(dataset, range(n)):
        img_loss, bs = 0.0, 1
        for s, (lr, hr, _name) in batch.items():
            lr = torch.from_numpy(lr).to(device)
            hr = torch.from_numpy(hr).to(device)
            bs = lr.shape[0]
            loss, preds = task.loss_and_preds({s: (lr, hr)},
                                              bsize=task.eval_bsize)
            p = M.calc_psnr(preds[s], hr, dataset="div2k", scale=s)
            img_loss += float(loss)
            psnrs.setdefault(s, WeightedMean()).update(float(p), bs)
        losses.update(img_loss / max(len(batch), 1), bs)
    out = {"val_loss": losses.compute()}
    for s, wm in psnrs.items():
        out[f"val_psnr_x{s:g}"] = wm.compute()
    return out


@torch.inference_mode()
def test_metrics(task: SRTask, dataset, *, max_images: Optional[int] = None,
                 device="cuda", evaluator=None) -> Dict[str, float]:
    """Benchmark test loop: psnr/ssim/lr_psnr per scale, averaged over
    images. ``evaluator`` (the JAX ``jit_cache``): a
    ``bucketed.BucketedEval`` of ``task``, which takes each image pair as
    host arrays; None evaluates each image at its exact shape."""
    acc: Dict[str, WeightedMean] = {}
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    for _, batch in pipeline.eval_batches(dataset, range(n)):
        for s, (lr, hr, _name) in batch.items():
            bs = lr.shape[0]
            if evaluator is not None:
                vals = evaluator.test_fn(s, lr.shape, hr.shape)(lr, hr)
            else:
                lr = torch.from_numpy(lr).to(device)
                hr = torch.from_numpy(hr).to(device)
                pred = task.predict(lr, (hr.shape[1], hr.shape[2]))
                vals = torch.stack([M.psnr(pred, hr), M.ssim(pred, hr),
                                    M.lr_psnr(pred, hr, s)]).tolist()
            for key, v in zip(("test_psnr", "test_ssim", "test_lr_psnr"),
                              vals):
                acc.setdefault(f"{key}_x{s:g}", WeightedMean()).update(v, bs)
    return {k: wm.compute() for k, wm in acc.items()}


def train(cfg: Config, *, max_steps: Optional[int] = None, device="cuda",
          log_fn=None) -> TrainState:
    """The epoch loop: ``max_epochs`` epochs (or until ``max_steps``
    global steps, which ends the epoch early), each followed by validation
    and the best/last checkpoints when ``check_val_every_n_epoch``
    divides it. ``trainer.resume`` continues the ``last`` checkpoint of
    that directory at the epoch after its own, to the same
    ``max_epochs``; ``trainer.profile_dir`` traces ``profile_steps`` steps
    after two warm-up steps; ``trainer.debug_nans`` raises on a
    non-finite loss or gradient. Under a process group every rank calls
    it, on its own ``device``; ``trainer.mesh_data`` x
    ``trainer.mesh_space`` must be the world size (ValueError otherwise,
    one process included)."""
    tr = cfg.trainer
    mesh = pmesh.make_mesh(tr.mesh_data, tr.mesh_space)
    lead = mesh.rank == 0
    logger = MetricsLogger(tr.log_dir if lead else None,
                           stdout=lead and log_fn is None)
    log_fn = (log_fn or print) if lead else (lambda *a: None)
    d = cfg.data
    if d.batch_size % mesh.data.size:
        raise ValueError(f"batch_size {d.batch_size} must divide across "
                         f"data={mesh.data.size} ranks")
    shard_batch = d.batch_size // mesh.data.size
    train_ds, val_ds = make_datasets(cfg)
    steps_per_epoch = max(1, (len(train_ds) * d.trainsets_repeat)
                          // d.batch_size)
    state = init_state(cfg, steps_per_epoch, device=device)
    ckpt = CheckpointManager(tr.ckpt_dir)
    start_epoch = 0
    if tr.resume:
        # checkpoints are written after the epoch's validation: continue
        # at the next epoch, to the same configured total (the schedule
        # keys on the restored step, so data order and schedule agree)
        meta = restore_state(state, tr.resume)
        start_epoch = int(meta.get("epoch", -1)) + 1
        log_fn(f"resumed from {tr.resume} @ step {meta['step']}, "
               f"epoch {start_epoch}")
    if pmesh.world()[1] > 1:
        for p in state.task.net.parameters():
            pmesh.broadcast_(p.data)
    step_fn = make_train_step(state, debug_nans=tr.debug_nans, mesh=mesh)
    first_step = state.step
    prof = (profiling.StepProfiler(tr.profile_dir, tr.profile_steps,
                                   first_step)
            if tr.profile_dir and lead else None)
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if tr.debug_nans:
            stack.enter_context(profiling.enable_debug_nans(True))
        if prof is not None:
            stack.callback(prof.close)
        for epoch in range(start_epoch, tr.max_epochs):
            if max_steps is not None and state.step >= max_steps:
                break
            losses = []
            for batch in pipeline.train_batches(
                    train_ds, batch_size=shard_batch, epoch=epoch,
                    seed=cfg.seed, repeat=d.trainsets_repeat,
                    num_workers=d.num_workers,
                    shard_index=mesh.data.index,
                    num_shards=mesh.data.size):
                m = step_fn(to_device(batch, device))
                if prof:
                    prof.after_step(state.step)
                losses.append(m["loss"])
                if state.step % tr.log_every_n_steps == 0 and lead:
                    logger.log(state.step,
                               {"train_loss": float(m["loss"]),
                                "grad_norm": float(m["grad_norm"])},
                               epoch=epoch)
                if max_steps is not None and state.step >= max_steps:
                    break
            if (epoch + 1) % tr.check_val_every_n_epoch == 0 and lead:
                vm = validate(state.task, val_ds,
                              max_images=tr.limit_val_images, device=device)
                vm["train_loss"] = (float(torch.stack(losses).mean())
                                    if losses else float("nan"))
                vm["steps_per_s"] = ((state.step - first_step)
                                     / max(time.time() - t0, 1e-9))
                logger.log(state.step, vm, epoch=epoch)
                ckpt.save(state.task.net, step=state.step,
                          val_loss=vm["val_loss"], config=to_dict(cfg),
                          epoch=epoch, optimizer=state.optimizer,
                          scheduler=state.scheduler)
            pmesh.barrier()
    logger.close()
    return state

"""Training and eval loops: the multi-scale train step, the epoch loop,
validation, benchmark metrics.

Counterpart of ``tpu_diinn/train/loop.py`` on one device, run eagerly:
PyTorch compiles nothing here, so the JAX package's per-shape jit cache
and its bucketed static-shape eval have no counterpart. A training step
is forward, multi-scale L1, backward (through the fused decoder's backward
kernels on a card), the global gradient norm and one Adam update, with
the learning rate keyed on the global step. Each epoch ends with a
full-image validation (loss and div2k-protocol PSNR per scale) and the
best/last checkpoints. Data parallelism, resuming and profiling are not
ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu_diinn_torch.config.config import Config, to_dict
from tpu_diinn_torch.data import datasets as ds
from tpu_diinn_torch.data import pipeline
from tpu_diinn_torch.nn.registry import make_net
from tpu_diinn_torch.train import metrics as M
from tpu_diinn_torch.train.checkpoint import (CheckpointManager,
                                              state_dict_from_jax)
from tpu_diinn_torch.train.logging import MetricsLogger
from tpu_diinn_torch.train.optim import make_optimizer
from tpu_diinn_torch.train.task import SRTask


def build_task(cfg: Config, *, device="cpu",
               generator: Optional[torch.Generator] = None) -> SRTask:
    m = cfg.model
    if m.dtype != "float32":
        raise NotImplementedError(
            f"model.dtype={m.dtype!r}: the port runs fp32 only so far "
            f"(bf16 mode: ROADMAP)")
    net = make_net(m.arch, mode=m.mode, init_q=m.init_q,
                   encoder_spec=m.encoder, hidden_dims=m.hidden_dims,
                   use_fused=m.use_fused, generator=generator)
    return SRTask(net=net.to(device), eval_bsize=m.eval_bsize)


@dataclasses.dataclass
class TrainState:
    task: SRTask
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def init_state(cfg: Config, steps_per_epoch: int, *, device="cpu",
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


def make_train_step(state: TrainState):
    """``step(batch) -> {"loss", "grad_norm"}`` (device scalars) for a
    batch {scale: (lr, hr)} of tensors on the net's device. The norm is
    taken over every parameter's gradient, as ``optax.global_norm``."""
    params = list(state.task.net.parameters())

    def step(batch) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss = state.task.train_loss(batch)
        loss.backward()
        gnorm = torch.stack([p.grad.square().sum() for p in params
                             if p.grad is not None]).sum().sqrt()
        apply_update(state)
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def to_device(batch, device) -> Dict[float, tuple]:
    """A numpy batch {scale: (lr, hr)} as tensors on ``device``."""
    return {s: (torch.from_numpy(lr).to(device),
                torch.from_numpy(hr).to(device))
            for s, (lr, hr) in batch.items()}


def _build_set(cfg: Config, name: str, split: str, *, scales,
               patch_size: int, augment: bool):
    """One dataset from a (name, split) config entry. DIV2K's train images
    split into ``train`` = [0:cut) and ``val`` = [cut:n), cut = 800 when
    all 900 are on disk, else 8/9 of what is (reduced copies keep a
    disjoint divide). Benchmark sets are used whole."""
    if name == "DIV2K":
        full = ds.SRDatasetDownsample(root=cfg.data.root, name="DIV2K",
                                      split="train", scales=scales,
                                      patch_size=patch_size, augment=augment)
        n = len(full)
        cut = 800 if n >= 900 else (n * 8) // 9
        return ds.Subset(full, range(0, cut) if split == "train"
                         else range(cut, n))
    return ds.SRDatasetDownsample(root=cfg.data.root, name=name, split=split,
                                  scales=scales, patch_size=patch_size,
                                  augment=augment)


def make_datasets(cfg: Config):
    """(train, val) from ``cfg.data``: augmented patches of every trainset
    at ``train_scales``, and full images of the first trainset's held-out
    tail; or synthetic images."""
    d = cfg.data
    if d.synthetic:
        train = ds.SyntheticSRDataset(n_images=16, scales=d.train_scales,
                                      patch_size=d.patch_size, seed=cfg.seed)
        val = ds.SyntheticSRDataset(n_images=2, scales=d.train_scales,
                                    patch_size=0, augment=False,
                                    seed=cfg.seed + 1, image_size=96)
        return train, val
    trains = [_build_set(cfg, name, split, scales=d.train_scales,
                         patch_size=d.patch_size, augment=True)
              for name, split in d.trainsets]
    train = trains[0] if len(trains) == 1 else ds.ConcatDataset(trains)
    val = _build_set(cfg, d.trainsets[0][0], "val", scales=d.train_scales,
                     patch_size=0, augment=False)
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
             device="cpu") -> Dict[str, float]:
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
                 device="cpu") -> Dict[str, float]:
    """Benchmark test loop: psnr/ssim/lr_psnr per scale, averaged over
    images."""
    acc: Dict[str, WeightedMean] = {}
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    for _, batch in pipeline.eval_batches(dataset, range(n)):
        for s, (lr, hr, _name) in batch.items():
            lr = torch.from_numpy(lr).to(device)
            hr = torch.from_numpy(hr).to(device)
            bs = lr.shape[0]
            pred = task.predict(lr, (hr.shape[1], hr.shape[2]))
            vals = torch.stack([M.psnr(pred, hr), M.ssim(pred, hr),
                                M.lr_psnr(pred, hr, s)]).tolist()
            for key, v in zip(("test_psnr", "test_ssim", "test_lr_psnr"),
                              vals):
                acc.setdefault(f"{key}_x{s:g}", WeightedMean()).update(v, bs)
    return {k: wm.compute() for k, wm in acc.items()}


def train(cfg: Config, *, max_steps: Optional[int] = None, device="cpu",
          log_fn=None) -> TrainState:
    """The epoch loop: ``max_epochs`` epochs (or until ``max_steps``
    global steps, which ends the epoch early), each followed by validation
    and the best/last checkpoints when ``check_val_every_n_epoch``
    divides it."""
    tr = cfg.trainer
    for key in ("resume", "profile_dir"):
        if getattr(tr, key):
            raise NotImplementedError(f"trainer.{key}: not ported yet "
                                      f"(ROADMAP)")
    if tr.debug_nans:
        raise NotImplementedError("trainer.debug_nans: not ported yet "
                                  "(ROADMAP)")
    logger = MetricsLogger(tr.log_dir, stdout=log_fn is None)
    d = cfg.data
    train_ds, val_ds = make_datasets(cfg)
    steps_per_epoch = max(1, (len(train_ds) * d.trainsets_repeat)
                          // d.batch_size)
    state = init_state(cfg, steps_per_epoch, device=device)
    ckpt = CheckpointManager(tr.ckpt_dir)
    step_fn = make_train_step(state)
    first_step = state.step
    t0 = time.time()
    for epoch in range(tr.max_epochs):
        if max_steps is not None and state.step >= max_steps:
            break
        losses = []
        for batch in pipeline.train_batches(
                train_ds, batch_size=d.batch_size, epoch=epoch,
                seed=cfg.seed, repeat=d.trainsets_repeat,
                num_workers=d.num_workers):
            m = step_fn(to_device(batch, device))
            losses.append(m["loss"])
            if state.step % tr.log_every_n_steps == 0:
                logger.log(state.step, {"train_loss": float(m["loss"]),
                                        "grad_norm": float(m["grad_norm"])},
                           epoch=epoch)
            if max_steps is not None and state.step >= max_steps:
                break
        if (epoch + 1) % tr.check_val_every_n_epoch == 0:
            vm = validate(state.task, val_ds,
                          max_images=tr.limit_val_images, device=device)
            vm["train_loss"] = (float(torch.stack(losses).mean())
                                if losses else float("nan"))
            vm["steps_per_s"] = ((state.step - first_step)
                                 / max(time.time() - t0, 1e-9))
            logger.log(state.step, vm, epoch=epoch)
            ckpt.save(state.task.net, step=state.step,
                      val_loss=vm["val_loss"], config=to_dict(cfg),
                      epoch=epoch)
    logger.close()
    return state

"""Rank-side functions of the port's multi-rank tests.

Run on every rank of a ``tpu_diinn_torch.parallel.launch.RankPool`` (gloo,
CPU) by ``tests/test_torch_parallel.py`` and
``tests/test_torch_multiprocess.py``; NOT collected by pytest. Imports
torch and the port only (the ranks never import JAX). Weights travel as
flat flax-path numpy dicts (``state_dict_from_jax``), results as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.nn.registry import make_encoder, make_net
from tpu_diinn_torch.parallel import sharding as sh
from tpu_diinn_torch.parallel.mesh import make_mesh
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train.checkpoint import (jax_from_state_dict,
                                              state_dict_from_jax)


def halo_slab(space: int, rows: int) -> np.ndarray:
    """This rank's halo-extended slab of a (1, 1, space * rows, 2) NCHW
    tensor whose row r holds r: column 0 of the slab."""
    mesh = make_mesh(1, space)
    x = torch.arange(float(space * rows))[None, None, :, None] \
        * torch.ones(1, 1, space * rows, 2)
    i = mesh.space.index
    slab = x[:, :, i * rows:(i + 1) * rows]
    return sh.halo_exchange(slab, 1, mesh.space, dim=2)[0, 0, :, 0].numpy()


def encoder_sharded(spec: str, flat: dict, x: np.ndarray,
                    space: int) -> np.ndarray:
    """The halo-sharded encoder's features (whole grid, every rank)."""
    mesh = make_mesh(1, space)
    enc = make_encoder(spec, halo=mesh.space)
    enc.load_state_dict(state_dict_from_jax(flat), strict=True)
    return sh.sharded_encoder_apply(enc, torch.from_numpy(x),
                                    mesh).numpy()


def _net(arch: str, flat: dict, **kw):
    net = make_net(arch, encoder_spec="rdn-tiny", hidden_dims=(32, 32), **kw)
    net.load_state_dict(state_dict_from_jax(flat), strict=True)
    return net


def decode_sharded(arch: str, flat: dict, x: np.ndarray, size, data: int,
                   space: int) -> np.ndarray:
    mesh = make_mesh(data, space)
    return sh.decode_sharded(_net(arch, flat), torch.from_numpy(x),
                             tuple(size), mesh).numpy()


def streaming(flat: dict, x: np.ndarray, size, band_rows: int,
              space: int):
    from tpu_diinn_torch.train.streaming import predict_streaming
    return predict_streaming(_net("diinn", flat), x, tuple(size),
                             band_rows=band_rows,
                             mesh=make_mesh(-1, space))


def train_step(overrides: list, flat: dict, batch: dict, data: int,
               space: int) -> dict:
    """One sharded ``make_train_step`` from ``flat`` on the global numpy
    ``batch``: this rank feeds its 'data' shard. Returns the step's
    metrics and (rank 0) the updated params."""
    mesh = make_mesh(data, space)
    cfg = load_config(None, overrides)
    state = loop.init_state(cfg, 1000, device="cpu", params=flat)
    step = loop.make_train_step(state, mesh=mesh)
    n = next(iter(batch.values()))[0].shape[0] // data
    lo = mesh.data.index * n
    mine = {s: (lr[lo:lo + n], hr[lo:lo + n]) for s, (lr, hr) in
            batch.items()}
    m = step(loop.to_device(mine, "cpu"))
    out = {k: float(v) for k, v in m.items()}
    if mesh.rank == 0:
        out["params"] = jax_from_state_dict(state.task.net.state_dict())
    return out


def cli_train(args: list):
    """``cli.train.main(args)`` on this rank; rank 0 returns the final
    params (flat flax paths) and the logged records."""
    import json
    from pathlib import Path
    from tpu_diinn_torch.cli import train as train_cli
    import torch.distributed as dist
    state = train_cli.main(args)
    if dist.get_rank() != 0:
        return None
    log_dir = next(a.split("=", 1)[1] for a in args
                   if a.startswith("trainer.log_dir="))
    path = Path(log_dir) / "metrics.jsonl"
    records = [json.loads(ln) for ln in path.read_text().splitlines()] \
        if path.exists() else []
    return {"step": state.step, "records": records,
            "params": jax_from_state_dict(state.task.net.state_dict())}


def make_mesh_error(data: int, space: int) -> str:
    """The error of a layout that does not fit the world ('' if none)."""
    try:
        make_mesh(data, space)
    except ValueError as e:
        return str(e)
    return ""


def shard_batches(dataset, batch_size: int, epoch: int, seed: int,
                  num_workers: int):
    """This process's pid and this rank's shard of ``train_batches`` over
    ``dataset`` (its samples made by ``num_workers`` worker processes)."""
    import os
    import torch.distributed as dist
    from tpu_diinn_torch.data import pipeline
    return os.getpid(), list(pipeline.train_batches(
        dataset, batch_size=batch_size, epoch=epoch, seed=seed,
        num_workers=num_workers, shard_index=dist.get_rank(),
        num_shards=dist.get_world_size()))

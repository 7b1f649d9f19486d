"""Port parity for the training slice: data, schedule, CLI, checkpoints.

- ``train_batches`` of the port equal the JAX numpy path's byte for byte
  (DIV2K patches with augmentation, first batches of two epochs).
- The LR schedule equals ``step_decay_schedule`` at and around every
  boundary (exact: both are products of powers of gamma), and update k
  runs at the rate of step k.
- ``cli.train --device cpu --max-steps 2`` writes ``last.npz`` (and
  refuses ``--device cuda`` without a card), and a port checkpoint loads
  through the JAX package's ``load_params_npz`` to the same arrays, on
  which a JAX net gives the port's output (atol 1e-5, fp32 sum order).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.config.config import load_config as jload_config
from tpu_diinn.data import datasets as jds
from tpu_diinn.data import pipeline as jpipe
from tpu_diinn.train import loop as jloop
from tpu_diinn.train.checkpoint import load_params_npz as jload_npz
from tpu_diinn.train.optim import step_decay_schedule
from tpu_diinn_torch.cli import train as tcli
from tpu_diinn_torch.config.config import load_config, to_dict
from tpu_diinn_torch.data import datasets as tds
from tpu_diinn_torch.data import pipeline as tpipe
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train.checkpoint import (CheckpointManager,
                                              jax_from_state_dict,
                                              load_params_npz)
from tpu_diinn_torch.train.optim import step_decay_factor

REPO = Path(__file__).resolve().parents[1]
TINY = ["model.encoder=rdn-tiny", "model.hidden_dims=[32,32,32]",
        "data.synthetic=true", "data.batch_size=2", "data.patch_size=12",
        "data.trainsets_repeat=1"]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def test_train_batches_match_jax_numpy_path():
    """DIV2K, 48-px patches at {2, 3, 4} with augmentation: the first two
    batches of epochs 0 and 1."""
    kw = dict(root=str(REPO / "data"), name="DIV2K", split="train",
              scales=[2, 3, 4], patch_size=48, augment=True)
    j = jds.SRDatasetDownsample(use_native=False, **kw)
    t = tds.SRDatasetDownsample(use_native=False, **kw)
    assert len(j) == len(t) > 0
    for epoch in (0, 1):
        args = dict(batch_size=4, epoch=epoch, seed=123, repeat=20,
                    num_workers=2)
        jb = jpipe.train_batches(j, **args)
        tb = tpipe.train_batches(t, **args)
        for _ in range(2):
            a, b = next(jb), next(tb)
            assert list(a) == list(b) == [2, 3, 4]
            for s in a:
                assert a[s][0].dtype == b[s][0].dtype == np.float32
                np.testing.assert_array_equal(a[s][0], b[s][0])
                np.testing.assert_array_equal(a[s][1], b[s][1])
        jb.close()
        tb.close()


def test_train_batches_in_process_match_jax_numpy_path():
    """``num_workers=0`` makes the samples in the calling process: the
    same batches as the JAX numpy path's (and so as the workers')."""
    kw = dict(root=str(REPO / "data"), name="DIV2K", split="train",
              scales=[2, 3.5], patch_size=24, augment=True)
    j = jds.SRDatasetDownsample(use_native=False, **kw)
    t = tds.SRDatasetDownsample(use_native=False, **kw)
    args = dict(batch_size=3, epoch=1, seed=7, repeat=2, num_workers=0)
    jb = jpipe.train_batches(j, **args)
    tb = tpipe.train_batches(t, **args)
    for _ in range(2):
        a, b = next(jb), next(tb)
        assert list(a) == list(b) == [2, 3.5]
        for s in a:
            np.testing.assert_array_equal(a[s][0], b[s][0])
            np.testing.assert_array_equal(a[s][1], b[s][1])
    jb.close()
    tb.close()


@pytest.mark.parametrize("steps_per_epoch", [1, 7, 800])
def test_lr_schedule_matches_step_decay_schedule(steps_per_epoch):
    sched = step_decay_schedule(1.0, steps_per_epoch, 10, 0.5, 50)
    bounds = [e * steps_per_epoch for e in range(10, 51, 10)]
    for b in [0] + bounds:
        for step in (b - 1, b, b + 1):
            if step >= 0:
                assert step_decay_factor(step, steps_per_epoch, 10, 0.5,
                                         50) == float(sched(step)), step
    # and as the optimizer sees it: update k uses the rate of step k
    cfg = load_config(None, TINY)
    state = loop.init_state(cfg, steps_per_epoch, device="cpu")
    for k in range(0, 12 * steps_per_epoch, max(1, steps_per_epoch)):
        while state.step < k:
            loop.apply_update(state)
        lr = state.optimizer.param_groups[0]["lr"]
        assert lr == pytest.approx(1e-4 * float(sched(k)), rel=1e-12)


def test_cli_train_writes_a_checkpoint(tmp_path):
    state = tcli.main(["--device", "cpu", "--max-steps", "2",
                       "data.synthetic=true", "model.encoder=rdn-tiny",
                       "model.hidden_dims=[32,32,32]", "data.patch_size=12",
                       "data.num_workers=2", f"trainer.ckpt_dir={tmp_path}",
                       f"trainer.log_dir={tmp_path}"])
    assert state.step == 2
    flat, meta = load_params_npz(str(tmp_path / "last.npz"))
    assert meta["step"] == 2 and meta["epoch"] == 0
    assert np.isfinite(meta["val_loss"])
    assert meta["config"]["model"]["encoder"] == "rdn-tiny"
    want = jax_from_state_dict(state.task.net.state_dict())
    assert set(flat) == set(want)
    assert all(np.array_equal(flat[k], want[k]) for k in want)
    records = [json.loads(ln) for ln in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert records[-1]["step"] == 2 and "steps_per_s" in records[-1]


def test_cli_train_refuses_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--max-steps", "1", "data.synthetic=true",
                   f"trainer.ckpt_dir={tmp_path}"])


def test_port_checkpoint_loads_through_jax(tmp_path):
    """A port checkpoint is a compact export the JAX package reads: the
    same arrays, and a JAX net built from its config runs on them."""
    cfg = load_config(None, TINY)
    state = loop.init_state(cfg, 10, device="cpu")
    CheckpointManager(str(tmp_path)).save(state.task.net, step=3,
                                          val_loss=0.25,
                                          config=to_dict(cfg), epoch=1)
    jstate, meta = jload_npz(str(tmp_path / "best.npz"))
    assert meta["step"] == 3 and meta["val_loss"] == 0.25
    variables = jstate["params"]     # as the flagship export: {"params": ...}
    want = jax_from_state_dict(state.task.net.state_dict())
    got = _flatten(variables)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v)
    jcfg = jload_config(None, TINY)
    x = np.random.default_rng(0).uniform(0, 1, (1, 6, 6, 3)).astype(
        np.float32)
    out = jloop.build_task(jcfg).net.apply(variables, jnp.asarray(x),
                                           (12, 12))
    with torch.no_grad():
        ref = state.task.net(torch.from_numpy(x), (12, 12))
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), rtol=0,
                               atol=1e-5)


def test_library_entry_points_default_to_the_card():
    """``build_task``, ``init_state``, ``validate``, ``test_metrics`` and
    ``train`` run on the card unless the caller asks for the CPU, as the
    CLIs do (the tests here pass ``device="cpu"``)."""
    import inspect
    for fn in (loop.build_task, loop.init_state, loop.validate,
               loop.test_metrics, loop.train):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__name__

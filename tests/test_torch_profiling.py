"""Port parity for the trainer's profiling and NaN-hunting switches
(``train/profiling.py``, ``trainer.profile_dir``, ``trainer.debug_nans``).

- ``trainer.profile_dir`` traces ``profile_steps`` steps after two
  warm-up steps, as the JAX trainer's ``maybe_profile``: the Chrome trace
  holds the annotations of steps 3-5 of an 8-step run and no others.
- A NaN injected into a decoder weight makes a training step raise
  ``FloatingPointError`` in the port, as it does in the JAX package under
  ``jax_debug_nans``.
- ``trainer.debug_nans`` leaves finite runs unchanged: the same losses
  and parameters, bit for bit, as without it.
- ``synced_time`` calls its function ``warmup + iters`` times.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_diinn.config.config import load_config as jload_config
from tpu_diinn.train import loop as jloop
from tpu_diinn.train import profiling as jprofiling
from tpu_diinn.train.optim import make_optimizer as jmake_optimizer
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.data import datasets as tds
from tpu_diinn_torch.data import pipeline as tpipe
from tpu_diinn_torch.train import loop, profiling
from tpu_diinn_torch.train.checkpoint import jax_from_state_dict
from tests.test_torch_train import TINY, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# one scale and the smallest encoder: the JAX package initialises its
# parameters op by op, which takes seconds for RDN-tiny here
ONE_SCALE = TINY + ["data.train_scales=[2]",
                    "model.encoder=edsr-baseline-tiny",
                    "model.hidden_dims=[16,16]"]


def _cfg(tmp_path, *extra):
    return load_config(None, TINY + [
        "data.num_workers=0", "trainer.check_val_every_n_epoch=1000",
        "trainer.log_every_n_steps=1", f"trainer.ckpt_dir={tmp_path}",
        f"trainer.log_dir={tmp_path}", *extra])


def test_trace_window_after_two_warmup_steps(tmp_path):
    prof_dir = tmp_path / "profile"
    state = loop.train(_cfg(tmp_path, f"trainer.profile_dir={prof_dir}",
                            "trainer.profile_steps=3"),
                       max_steps=8, device="cpu", log_fn=lambda *a: None)
    assert state.step == 8
    traces = list(prof_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    steps = sorted(e["name"] for e in events
                   if str(e.get("name", "")).startswith("train_step "))
    assert steps == ["train_step 3", "train_step 4", "train_step 5"]


def test_injected_nan_raises_as_in_jax():
    d = tds.SyntheticSRDataset(n_images=4, scales=(2,), patch_size=12,
                               seed=5)
    it = tpipe.train_batches(d, batch_size=2, epoch=0, seed=9,
                             num_workers=0)
    batches = [next(it), next(it)]
    it.close()
    # JAX: one step under jax_debug_nans with a NaN decoder weight
    jcfg = jload_config(None, ONE_SCALE)
    tx = jmake_optimizer(1e-4, 1000)
    jstate = jloop.init_state(jcfg, tx, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda a: a, jstate.params)
    kernel = params["params"]["decoder"]["q1"]["dense"]["kernel"]
    params["params"]["decoder"]["q1"]["dense"]["kernel"] = \
        kernel.at[0, 0].set(jnp.nan)
    jstate = jstate.replace(params=params)
    step = jloop.make_train_step(jloop.build_task(jcfg), tx, donate=False)
    jbatch = {s: (jnp.asarray(lr), jnp.asarray(hr))
              for s, (lr, hr) in batches[0].items()}
    jprofiling.enable_debug_nans(True)
    try:
        with pytest.raises(FloatingPointError):
            step(jstate, jbatch)
    finally:
        jprofiling.enable_debug_nans(False)
    # the port: the same weight set to NaN
    state = loop.init_state(load_config(None, ONE_SCALE), 1000, device="cpu")
    with profiling.enable_debug_nans(True):
        step = loop.make_train_step(state, debug_nans=True)
        step(loop.to_device(batches[0], "cpu"))
        state.task.net.decoder.q1.dense.weight.data[0, 0] = float("nan")
        with pytest.raises(FloatingPointError, match="step 2: loss"):
            step(loop.to_device(batches[1], "cpu"))


def test_debug_nans_leaves_finite_runs_unchanged(tmp_path):
    runs = {}
    for on in (False, True):
        out = tmp_path / str(on)
        state = loop.train(_cfg(out, f"trainer.debug_nans={on}"),
                           max_steps=2, device="cpu",
                           log_fn=lambda *a: None)
        losses = [json.loads(ln)["train_loss"] for ln in
                  (out / "metrics.jsonl").read_text().splitlines()]
        runs[on] = (losses, jax_from_state_dict(state.task.net.state_dict()))
    assert len(runs[True][0]) == 2 and runs[True][0] == runs[False][0]
    for k, v in runs[False][1].items():
        np.testing.assert_array_equal(runs[True][1][k], v, err_msg=k)


def test_synced_time_calls_warmup_plus_iters():
    calls = []
    secs = profiling.synced_time(lambda x: calls.append(x), 7, iters=5,
                                 warmup=3)
    assert calls == [7] * 8 and secs >= 0.0

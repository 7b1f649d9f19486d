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
- The program's spans (``profiling.span``): a training step and its
  batch copy, and a chunked request, leave their named ranges on a
  running profiler's timeline, each inside its parent; with no profiler
  a span is one shared null context and records nothing.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _host_ranges(prof) -> dict:
    """name -> [(start us, end us)] of every range the profiler recorded."""
    out = {}
    for ev in prof.events():
        out.setdefault(ev.name, []).append((ev.time_range.start,
                                            ev.time_range.end))
    return out


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def test_a_step_and_its_batch_copy_record_nested_spans():
    from torch.profiler import ProfilerActivity, profile
    cfg = load_config(None, TINY + ["data.train_scales=[2,3]"])
    state = loop.init_state(cfg, 1000, device="cpu")
    step = loop.make_train_step(state)
    d = tds.SyntheticSRDataset(n_images=2, scales=(2, 3), patch_size=12,
                               seed=5)
    it = tpipe.train_batches(d, batch_size=2, epoch=0, seed=9,
                             num_workers=0)
    batch = next(it)
    it.close()
    step(loop.to_device(batch, "cpu"))      # step 1, no profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(loop.to_device(batch, "cpu"))
    r = _host_ranges(prof)
    (whole,) = r["train_step 2"]
    assert "train_step 1" not in r
    (feed,) = r["to_device"]
    assert feed[1] <= whole[0]
    (fwd,) = r["step.forward"]
    (bwd,) = r["step.backward"]
    assert all(_inside(s, whole) for s in (fwd, bwd, *r["step.update"]))
    assert fwd[1] <= bwd[0] <= bwd[1] <= max(e for _, e in r["step.update"])
    (enc,) = r["encoder"]                   # one pass over both scales
    assert _inside(enc, fwd)
    assert len(r["decoder"]) == 2 and all(_inside(d, fwd)
                                          for d in r["decoder"])
    for name, parents in (("lr_conv", "decoder"),
                          ("decoder.prepare", "decoder"),
                          ("decoder.backward", "step.backward")):
        assert r[name] and all(any(_inside(c, p) for p in r[parents])
                               for c in r[name]), name
    # the two scales' prepares: grid and packing, then casts and slabs
    assert len(r["decoder.prepare"]) == 4
    # the CPU's backward takes the plain version: no kernel buffers
    assert "decoder.backward.prepare" not in r


def test_a_chunked_request_records_one_window_span_a_chunk():
    from torch.profiler import ProfilerActivity, profile
    cfg = load_config(None, TINY + ["model.eval_bsize=44"])
    task = loop.build_task(cfg, device="cpu")
    lr = torch.rand((1, 7, 9, 3), generator=torch.Generator().manual_seed(3))
    size = (22, 28)                          # x3.14, 44 // 22 = 2 columns
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        out = task.predict(lr, size)
    assert out.shape == (1, 22, 28, 3)
    r = _host_ranges(prof)
    (whole,) = r["predict"]
    (dec,) = r["decoder"]
    assert _inside(r["encoder"][0], whole) and _inside(dec, whole)
    assert len(r["decoder.window"]) == 14
    assert all(_inside(w, dec) for w in r["decoder.window"])
    # the packed weights and index vectors once, then each window's grid
    # and the weight casts of each window's decode
    assert len(r["decoder.prepare"]) == 1 + 14 * 2


def test_a_span_without_a_profiler_is_one_shared_null_context():
    from torch.profiler import ProfilerActivity, profile
    first = profiling.span("to_device")
    assert isinstance(first, contextlib.nullcontext)
    assert all(profiling.span(n) is first
               for n in ("encoder", "decoder", "train_step 7"))
    opened = profiling.span("decoder.prepare")
    opened.__enter__()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inner = profiling.span("decoder.window")
        with inner:
            torch.ones(3).sum()
        assert inner is not first
    opened.__exit__(None, None, None)
    assert profiling.span("decoder") is first
    names = set(_host_ranges(prof))
    assert "decoder.window" in names and "decoder.prepare" not in names

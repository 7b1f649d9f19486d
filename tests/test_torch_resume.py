"""Port parity for resuming a training run (``trainer.resume``).

- 2 epochs in one run against 1 epoch plus 1 resumed epoch, in the port:
  the same parameters and Adam state bit for bit, the same step, and the
  learning rate of the resumed run halved at the epoch boundary
  (``model.lr_step=1``), keyed on the restored step.
- The port's resumed run against the JAX package's resumed run (the
  configuration of ``tests/test_train.py``'s resume test with
  ``model.lr_step=1``; the port from the JAX init's parameters): the
  step, and the parameters within ``tests/test_torch_train.py``'s 1e-5
  (fp32 sum order; each Adam step moves a parameter by about 1e-4).
- The checkpoint holds the parameters alone in ``last.npz`` and the
  training state beside it (``best`` has none); resuming from a directory
  without the training state raises and names the file, and a pair whose
  steps disagree is refused.
"""

import functools
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from tpu_diinn.config.config import load_config as jload_config
from tpu_diinn.train import loop as jloop
from tpu_diinn.train.optim import make_optimizer as jmake_optimizer
from tpu_diinn_torch.config.config import load_config, to_dict
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train.checkpoint import (CheckpointManager,
                                              jax_from_state_dict,
                                              load_params, load_params_npz)
from tests.test_torch_train import _flatten, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _overrides(ckpt, max_epochs, resume=None):
    """``tests/test_train.py``'s resume configuration, with the samples made
    in the training process (one loader thread in JAX) and
    ``model.lr_step=1``: the rate halves at the epoch boundary, after the
    resume point."""
    ov = ["model.encoder=edsr-baseline-tiny", "model.hidden_dims=[16,16]",
          "data.synthetic=true", "data.batch_size=8", "data.patch_size=16",
          "data.train_scales=[2]", "data.trainsets_repeat=1",
          "data.num_workers=0", "model.lr_step=1",
          f"trainer.max_epochs={max_epochs}", "trainer.limit_val_images=1",
          f"trainer.ckpt_dir={ckpt}"]
    if resume:
        ov.append(f"trainer.resume={resume}")
    return ov


def _train(ov):
    return loop.train(load_config(None, ov), device="cpu",
                      log_fn=lambda *a: None)


def _params(state):
    return jax_from_state_dict(state.task.net.state_dict())


def _adam(state):
    return [(k, v.clone()) for st in state.optimizer.state.values()
            for k, v in sorted(st.items())]


def _jax_init(ckpt):
    """The JAX trainer's initial parameters (``PRNGKey(cfg.seed)``)."""
    cfg = jload_config(overrides=_overrides(ckpt, 1))
    tx = jmake_optimizer(1e-4, 1)
    return _flatten(jloop.init_state(cfg, tx, jax.random.PRNGKey(cfg.seed))
                    .params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's 1 epoch + resumed epoch; the port's 2 straight
    epochs, 1 epoch and the resumed epoch, from the JAX init's parameters
    (the learning rate of each resumed update recorded)."""
    d = tmp_path_factory.mktemp("resume")
    silent = lambda *a, **k: None  # noqa: E731
    jloop.train(jload_config(overrides=_overrides(d / "jb", 1)),
                log_fn=silent)
    jax_resumed = jloop.train(jload_config(overrides=_overrides(
        d / "jb2", 2, d / "jb")), log_fn=silent)
    lrs = []
    orig = loop.apply_update

    def recording(state):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        orig(state)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "init_state", functools.partial(
            loop.init_state, params=_jax_init(str(d / "jb"))))
        straight = _train(_overrides(d / "a", 2))
        part = _train(_overrides(d / "b", 1))
        mp.setattr(loop, "apply_update", recording)
        resumed = _train(_overrides(d / "c", 2, d / "b"))
    return dict(dir=d, jax=jax_resumed, straight=straight, part=part,
                resumed=resumed, lrs=lrs)


def test_resume_reproduces_straight_run(runs):
    straight, part, resumed = runs["straight"], runs["part"], runs["resumed"]
    assert part.step == 2 and straight.step == resumed.step == 4
    # model.lr_step=1: the rate halves after epoch 1, keyed on the step
    assert runs["lrs"] == [0.5e-4, 0.5e-4]
    a, b = _params(straight), _params(resumed)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for (ka, va), (kb, vb) in zip(_adam(straight), _adam(resumed)):
        assert ka == kb and torch.equal(va, vb), ka
    assert (straight.optimizer.param_groups[0]["lr"]
            == resumed.optimizer.param_groups[0]["lr"])
    # the params file holds exactly the parameters (the JAX package's
    # load_params_npz reads every key as one)
    flat, meta = load_params_npz(str(runs["dir"] / "b" / "last.npz"))
    assert set(flat) == set(_params(part)) and meta["step"] == 2
    # the training state sits beside last only: resume reads nothing else
    assert sorted(p.name for p in (runs["dir"] / "b").glob("*.npz")) == [
        "best.npz", "last.npz", "last.train_state.npz"]


def test_resumed_run_matches_jax(runs):
    want, got = runs["jax"], runs["resumed"]
    assert got.step == int(want.step) == 4
    want_p, got_p = _flatten(want.params), _params(got)
    assert set(got_p) == set(want_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_load_params_reads_an_export_a_directory_and_a_tag(runs, tmp_path):
    """``load_params`` as the JAX package's: a directory means its best."""
    shutil.copy(runs["dir"] / "a" / "last.npz", tmp_path / "best.npz")
    shutil.copy(runs["dir"] / "b" / "last.npz", tmp_path / "last.npz")
    for path, step in ((tmp_path, 4), (tmp_path / "best", 4),
                       (tmp_path / "last", 2), (tmp_path / "last.npz", 2)):
        flat, meta = load_params(str(path))
        assert meta["step"] == step, path
        assert set(flat) == set(_params(runs["part"]))


def test_resume_refuses_a_mismatched_pair(runs, tmp_path):
    for f in ("last.npz", "last.train_state.npz"):
        shutil.copy(runs["dir"] / "b" / f, tmp_path / f)
    shutil.copy(runs["dir"] / "a" / "last.npz", tmp_path / "last.npz")
    with pytest.raises(ValueError, match="step 4"):
        CheckpointManager(str(tmp_path)).restore()


def test_resume_needs_the_training_state(tmp_path):
    cfg = load_config(None, _overrides(tmp_path / "x", 1))
    state = loop.init_state(cfg, 2, device="cpu")
    CheckpointManager(str(tmp_path / "params_only")).save(
        state.task.net, step=2, val_loss=0.5, config=to_dict(cfg), epoch=0)
    path = tmp_path / "params_only" / "last.train_state.npz"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        _train(_overrides(tmp_path / "y", 2, tmp_path / "params_only"))
    with pytest.raises(FileNotFoundError, match="nowhere"):
        _train(_overrides(tmp_path / "y", 2, tmp_path / "nowhere"))

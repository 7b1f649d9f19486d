"""Port parity for the training slice: the train step.

- Three ``make_train_step`` steps of a tiny DIINN (RDN-tiny, hidden 3 x 32)
  from the same params on the same batches: per-step loss (atol 1e-5),
  global gradient norm (rtol 1e-4) and final params (atol 1e-5), on the
  port's fused route (the kernels' plain versions on the CPU) and with
  ``use_fused=False``, at scales [2, 3] and [2, 2.5]. The JAX side runs
  its XLA path. The bounds cover fp32 summation order: the params move by
  about 1e-4 per Adam step, so 1e-5 holds each update to 10%.

Data, schedule, CLI and checkpoints: tests/test_torch_train_cli.py.

``jax_train_oracle`` also made the committed flagship oracle that
``chip_smoke.py`` holds the card against:

    python -m tests.test_torch_train --flagship-oracle \
        tpu_diinn_torch/testdata/flagship_train_jax_cpu.json
"""

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_diinn.config.config import load_config as jload_config
from tpu_diinn.data import datasets as jds
from tpu_diinn.data import pipeline as jpipe
from tpu_diinn.train import loop as jloop
from tpu_diinn.train.checkpoint import load_params_npz as jload_npz
from tpu_diinn.train.optim import make_optimizer as jmake_optimizer
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.data import datasets as tds
from tpu_diinn_torch.data import pipeline as tpipe
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train.checkpoint import jax_from_state_dict

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = REPO / "results" / "flagship_weights.npz"

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


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def jax_train_oracle(overrides, batches, n_steps, params=None, seed=0):
    """``n_steps`` JAX train steps (``tpu_diinn.train.loop.
    make_train_step``, XLA decoder path) on ``batches`` (numpy, {scale:
    (lr, hr)}), from flat ``params/...`` params or the JAX init of
    PRNGKey(seed). Returns (initial flat params, [{"loss", "grad_norm"}],
    final flat params)."""
    cfg = jload_config(None, overrides)
    tx = jmake_optimizer(cfg.model.lr, 1000, cfg.model.lr_step,
                         cfg.model.lr_gamma, cfg.trainer.max_epochs)
    state = jloop.init_state(cfg, tx, jax.random.PRNGKey(seed))
    if params is not None:
        state = state.replace(params=_unflatten(params),
                              opt_state=tx.init(_unflatten(params)))
    start = _flatten(state.params)
    step = jloop.make_train_step(jloop.build_task(cfg), tx, mesh=None,
                                 donate=False)
    metrics = []
    for batch in batches[:n_steps]:
        state, m = step(state, {s: (jnp.asarray(lr), jnp.asarray(hr))
                                for s, (lr, hr) in batch.items()})
        metrics.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"])})
    return start, metrics, _flatten(state.params)


def port_train(overrides, batches, n_steps, params):
    """The same steps through the port's ``make_train_step`` (CPU)."""
    cfg = load_config(None, overrides)
    state = loop.init_state(cfg, 1000, params=params)
    step = loop.make_train_step(state)
    metrics = []
    for batch in batches[:n_steps]:
        m = step(loop.to_device(batch, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax_from_state_dict(state.task.net.state_dict())


@functools.lru_cache(maxsize=None)
def _tiny_batches(scales, n=3):
    d = tds.SyntheticSRDataset(n_images=8, scales=scales, patch_size=12,
                               seed=5)
    it = tpipe.train_batches(d, batch_size=2, epoch=0, seed=9, repeat=1,
                             num_workers=1)
    batches = [next(it) for _ in range(n)]
    it.close()
    return batches


@pytest.mark.parametrize("use_fused", [None, False])
@pytest.mark.parametrize("scales", [[2, 3], [2, 2.5]])
def test_train_steps_match_jax(use_fused, scales):
    ov = TINY + [f"data.train_scales={json.dumps(scales)}"]
    batches = _tiny_batches(tuple(scales))
    start, want, want_params = jax_train_oracle(ov, batches, 3)
    port_ov = ov + [f"model.use_fused={json.dumps(use_fused)}"]
    got, got_params = port_train(port_ov, batches, 3, start)
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-5, (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4 * w["grad_norm"]
    assert set(got_params) == set(want_params)
    for k, w in want_params.items():
        np.testing.assert_allclose(got_params[k], w, rtol=0, atol=1e-5,
                                   err_msg=k)


def flagship_oracle(n_steps=3):
    """The flagship JAX oracle of ``chip_smoke.py`` phase 5a: ``n_steps``
    steps at the default (flagship) configuration from
    ``results/flagship_weights.npz`` on the first batches of epoch 0
    (seed 123) of DIV2K[0:160), on the JAX numpy data path."""
    cfg = jload_config(None, [])
    d = cfg.data
    full = jds.SRDatasetDownsample(root=str(REPO / "data"), name="DIV2K",
                                   split="train", scales=d.train_scales,
                                   patch_size=d.patch_size, augment=True,
                                   use_native=False)
    n = len(full)
    train = jds.Subset(full, range(0, 800 if n >= 900 else (n * 8) // 9))
    it = jpipe.train_batches(train, batch_size=d.batch_size, epoch=0,
                             seed=cfg.seed, repeat=d.trainsets_repeat,
                             num_workers=4)
    batches = [next(it) for _ in range(n_steps)]
    state, _ = jload_npz(str(FLAGSHIP))
    _, metrics, _ = jax_train_oracle([], batches, n_steps,
                                     params=_flatten(state["params"]))
    return {"weights": "results/flagship_weights.npz", "seed": cfg.seed,
            "batches": f"first {n_steps} of epoch 0, DIV2K[0:{len(train)})",
            "steps": metrics}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--flagship-oracle"]:
        out = flagship_oracle()
        text = json.dumps(out, indent=1)
        Path(sys.argv[2]).write_text(text + "\n")
        print(text)

"""Port parity for the parallel layer: the counterparts of
``tests/test_sharding.py``, on four gloo ranks on the CPU.

The ranks are one ``RankPool`` for the module (spawned once, one torch
thread each) and run ``tests/torch_parallel_ranks.py``; the JAX side runs
in this process on the 8 virtual CPU devices of ``tests/conftest.py``
(each JAX mesh takes the first ``data x space`` of them). Weights are the
JAX ``init``'s, carried across by ``state_dict_from_jax``; inputs are
seeded numpy.

- the halo slab contents (exact, as the JAX test's literal);
- the halo-sharded encoder: bit-equal to the port's unsharded SAME stack,
  and within rtol/atol 1e-5 of JAX's ``sharded_encoder_apply``;
- ``decode_sharded`` for diinn, liif and metasr at divisible and
  non-divisible widths: bit-equal to the port's single-device decode,
  within 1e-5 of JAX's ``decode_sharded``;
- the space-sharded train step (mesh 1 x 4 and 2 x 2): loss within 1e-5
  and params within 3e-6 of the port's unsharded step (the JAX test's
  bounds for its own sharded step), and loss within 1e-5, grad norm
  within 1e-4 relative and params within 1e-5 of JAX's sharded step;
- ``predict_streaming(mesh=)``: only the space axis's first rank returns
  the image, within 1e-5 of the direct decode and (at a width JAX can
  shard) of JAX's sharded bands;
- mesh layouts that do not use every rank raise (ROADMAP C6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_diinn.config.config import load_config as jload_config
from tpu_diinn.nn.registry import make_encoder as jmake_encoder
from tpu_diinn.nn.registry import make_net as jmake_net
from tpu_diinn.parallel import sharding as jsh
from tpu_diinn.parallel.mesh import make_mesh as jmake_mesh
from tpu_diinn.train import loop as jloop
from tpu_diinn.train.optim import make_optimizer as jmake_optimizer
from tpu_diinn.train.streaming import predict_streaming as jstreaming
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.nn.registry import make_encoder, make_net
from tpu_diinn_torch.parallel.launch import RankPool
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train.checkpoint import (jax_from_state_dict,
                                              state_dict_from_jax)
from tpu_diinn_torch.train.task import SRTask

WORLD = 4
R = "tests.torch_parallel_ranks:"
TINY = ["model.encoder=rdn-tiny", "model.hidden_dims=[32,32]",
        "data.patch_size=16", "data.batch_size=4"]


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD, threads=1)
    yield p
    p.close()


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def _same_on_every_rank(results):
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])
    return results[0]


def test_halo_exchange_slab_contents(pool):
    got = np.concatenate(pool.run(R + "halo_slab", WORLD, 2))
    # the JAX test's slabs: [above, rows, below] per device
    want = np.array([0, 0, 1, 2, 1, 2, 3, 4, 3, 4, 5, 6, 5, 6, 7, 0],
                    dtype=np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", ["edsr-baseline-tiny", "rdn-tiny"])
def test_halo_sharded_encoder_matches_unsharded_and_jax(pool, spec):
    x = np.random.default_rng(0).random((2, 32, 16, 3)).astype(np.float32)
    jenc = jmake_encoder(spec, name="enc")
    params = jax.jit(jenc.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    flat = _flatten(params)
    got = _same_on_every_rank(pool.run(R + "encoder_sharded", spec, flat, x,
                                       WORLD))
    enc = make_encoder(spec)
    enc.load_state_dict(state_dict_from_jax(flat), strict=True)
    with torch.no_grad():
        want = enc(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    jhalo = jmake_encoder(spec, name="enc", halo_axis="space")
    mesh = jmake_mesh(1, WORLD)
    jgot = jax.jit(lambda p, xx: jsh.sharded_encoder_apply(
        jhalo, p, xx, mesh))(params, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _family(arch):
    net = jmake_net(arch, encoder_spec="rdn-tiny", hidden_dims=(32, 32))
    x = np.array(jax.random.uniform(jax.random.PRNGKey(0), (2, 16, 16, 3)))
    params = net.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]), (32, 32))
    return net, params, x


@pytest.mark.parametrize("arch,size,data,space", [
    ("diinn", (31, 40), 2, 2),                       # divisible widths
    *[(a, s, 1, WORLD) for a in ("diinn", "liif", "metasr")
      for s in ((64, 63), (41, 53))],               # clamped overhang
])
def test_decode_sharded_matches_single_device_and_jax(pool, arch, size,
                                                      data, space):
    jnet, params, x = _family(arch)
    x = x[:data]
    flat = _flatten(params)
    got = _same_on_every_rank(pool.run(R + "decode_sharded", arch, flat, x,
                                       size, data, space))
    net = make_net(arch, encoder_spec="rdn-tiny", hidden_dims=(32, 32))
    net.load_state_dict(state_dict_from_jax(flat), strict=True)
    with torch.no_grad():
        want = net(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, want)
    jgot = jsh.decode_sharded(jnet, params, jnp.asarray(x), size,
                              jmake_mesh(data, space))
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_train(data, space):
    """JAX's sharded step from its init: (start params, batch, metrics,
    params after)."""
    cfg = jload_config(overrides=TINY)
    tx = jmake_optimizer(cfg.model.lr, 1000, cfg.model.lr_step,
                         cfg.model.lr_gamma, cfg.trainer.max_epochs)
    state0 = jloop.init_state(cfg, tx, jax.random.PRNGKey(0))
    start = _flatten(state0.params)
    rng = np.random.default_rng(0)
    batch = {2.0: (rng.random((4, 16, 16, 3)).astype(np.float32),
                   rng.random((4, 32, 32, 3)).astype(np.float32))}
    mesh = jmake_mesh(data, space)
    step = jloop.make_train_step(jloop.build_task(cfg), tx, mesh=mesh,
                                 donate=False)
    state, m = step(state0, jloop.shard_batch(batch, mesh))
    return (start, batch, {k: float(v) for k, v in m.items()},
            _flatten(state.params))


@pytest.mark.parametrize("data,space", [(1, WORLD), (2, 2)])
def test_space_sharded_train_step_matches_unsharded_and_jax(pool, data,
                                                           space):
    start, batch, jm, jparams = _jax_train(data, space)
    res = pool.run(R + "train_step", TINY, start, batch, data, space)
    for r in res[1:]:
        assert r["loss"] == res[0]["loss"]
        assert r["grad_norm"] == res[0]["grad_norm"]
    got = res[0]
    state = loop.init_state(load_config(None, TINY), 1000, device="cpu",
                            params=start)
    m = loop.make_train_step(state)(loop.to_device(batch, "cpu"))
    want = jax_from_state_dict(state.task.net.state_dict())
    assert abs(got["loss"] - float(m["loss"])) <= 1e-5
    assert abs(got["loss"] - jm["loss"]) <= 1e-5
    assert abs(got["grad_norm"] - jm["grad_norm"]) <= 1e-4 * jm["grad_norm"]
    assert set(got["params"]) == set(want) == set(jparams)
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], rtol=0,
                                   atol=3e-6, err_msg=k)
        np.testing.assert_allclose(got["params"][k], jparams[k], rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("size", [(64, 64), (64, 61)])
def test_predict_streaming_sharded_matches_direct_and_jax(pool, size):
    """JAX shards a band's columns by a sharding constraint, which needs
    the width to divide; the port's clamped stripes take any width, and
    are held to JAX where JAX runs."""
    jnet, params, _ = _family("diinn")
    x = np.random.default_rng(0).random((1, 16, 16, 3)).astype(np.float32)
    flat = _flatten(params)
    res = pool.run(R + "streaming", flat, x, size, 16, WORLD)
    assert all(r is None for r in res[1:])
    got = res[0]
    net = make_net("diinn", encoder_spec="rdn-tiny", hidden_dims=(32, 32))
    net.load_state_dict(state_dict_from_jax(flat), strict=True)
    with torch.no_grad():
        want = SRTask(net).predict(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if size[1] % WORLD == 0:
        jgot = jstreaming(jnet, params, x, size, band_rows=16,
                          mesh=jmake_mesh(1, WORLD))
        np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("data,space", [(3, 1), (1, 3), (2, 4), (-1, 3),
                                        (8, 1), (0, 2)])
def test_mesh_layout_not_using_every_rank_raises(pool, data, space):
    errors = pool.run(R + "make_mesh_error", data, space)
    assert all(e and e == errors[0] for e in errors), errors

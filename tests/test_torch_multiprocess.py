"""The port's ``cli.train`` on several gloo ranks on the CPU: the
counterpart of ``tests/test_multihost.py``.

Two and four ranks (``tpu_diinn_torch.parallel.launch.RankPool``, spawned
once per layout, one torch thread each) run ``cli.train``'s ``main``
under torchrun's environment for two steps of a tiny synthetic
configuration: data-parallel on two ranks (``trainer.mesh_data=2``), and
2 x 2 (``trainer.mesh_data=2 trainer.mesh_space=2``: the batch over two
ranks, each scale's HR columns over two). Rank 0's parameters must match
(rtol 1e-4, atol 1e-5, as the JAX test):

- the port's one-rank run of the same configuration, and
- JAX's single-process run on a 4-device mesh ('data' 4, or 2 x 2) of
  the same global batches from the port's initial parameters.

A 2-rank run with ``debug_nans`` and a trace window resumes from its
checkpoint to one rank's straight run. Also here: the host-sharding order
against JAX's
``train_batches(shard_index=, num_shards=)``, and the layouts that do not
fit the world size, which raise (ROADMAP C6).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_diinn.config.config import load_config as jload_config
from tpu_diinn.data import pipeline as jpipe
from tpu_diinn.parallel.mesh import make_mesh as jmake_mesh
from tpu_diinn.train import loop as jloop
from tpu_diinn.train.optim import make_optimizer as jmake_optimizer
from tpu_diinn_torch.cli import train as train_cli
from tpu_diinn_torch.config.config import load_config
from tpu_diinn_torch.data import pipeline as tpipe
from tpu_diinn_torch.parallel.launch import RankPool
from tpu_diinn_torch.parallel.mesh import mesh_shape
from tpu_diinn_torch.train import loop
from tpu_diinn_torch.train.checkpoint import jax_from_state_dict

CFG = ["model.arch=diinn", "model.encoder=rdn-tiny",
       "model.hidden_dims=[32,32]", "model.eval_bsize=997",
       "data.synthetic=true", "data.batch_size=4", "data.train_scales=[2]",
       "data.patch_size=16", "data.num_workers=0", "data.trainsets_repeat=1",
       "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=10"]
N_STEPS = 2
LAYOUTS = {"dp": (2, ["trainer.mesh_data=2"], (4, 1)),
           "dp_x_sp": (4, ["trainer.mesh_data=2", "trainer.mesh_space=2"],
                       (2, 2))}


def _args(tmp: Path, tag: str, extra=()):
    return ["--device", "cpu", "--max-steps", str(N_STEPS), *CFG, *extra,
            f"trainer.ckpt_dir={tmp}/ckpt_{tag}",
            f"trainer.log_dir={tmp}/log_{tag}"]


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def _jax_run(mesh_shape_, start):
    """JAX's single-process run: the same global batches, from the port's
    initial params, on a ``mesh_shape_`` mesh of this process's devices."""
    cfg = jload_config(None, CFG)
    train_ds, _ = jloop.make_datasets(cfg)
    spe = (len(train_ds) * cfg.data.trainsets_repeat) // cfg.data.batch_size
    tx = jmake_optimizer(cfg.model.lr, spe, cfg.model.lr_step,
                         cfg.model.lr_gamma, cfg.trainer.max_epochs)
    state = jloop.init_state(cfg, tx, jax.random.PRNGKey(0))
    params = _unflatten(start)
    state = state.replace(params=params, opt_state=tx.init(params))
    mesh = jmake_mesh(*mesh_shape_)
    step = jloop.make_train_step(jloop.build_task(cfg), tx, mesh=mesh,
                                 donate=False)
    it = jpipe.train_batches(train_ds, batch_size=cfg.data.batch_size,
                             epoch=0, seed=cfg.seed, repeat=1, num_workers=1)
    for _ in range(N_STEPS):
        state, _ = step(state, jloop.shard_batch(next(it), mesh))
    it.close()
    return _flatten(state.params)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one_rank")
    cfg = load_config(None, CFG)
    train_ds, _ = loop.make_datasets(cfg)
    spe = len(train_ds) // cfg.data.batch_size
    start = jax_from_state_dict(loop.init_state(
        cfg, spe, device="cpu").task.net.state_dict())
    state = train_cli.main(_args(tmp, "one"))
    assert state.step == N_STEPS
    return start, jax_from_state_dict(state.task.net.state_dict())


@pytest.fixture(scope="module")
def pools():
    """Rank pools by world size, each started at first use and kept for
    the module."""
    made = {}
    yield lambda world: made.setdefault(world, RankPool(world, threads=1))
    for pool in made.values():
        pool.close()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cli_train_ranks_match_one_rank_and_jax(tmp_path, one_rank, pools,
                                                layout):
    world, extra, jshape = LAYOUTS[layout]
    res = pools(world).run("tests.torch_parallel_ranks:cli_train",
                           _args(tmp_path, layout, extra))
    assert all(r is None for r in res[1:])
    got = res[0]
    assert got["step"] == N_STEPS
    start, want = one_rank
    jwant = _jax_run(jshape, start)
    assert set(got["params"]) == set(want) == set(jwant)
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["params"][k], jwant[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # only rank 0 logs and writes: one log directory, no per-rank files
    assert (tmp_path / f"log_{layout}").is_dir()


def test_resume_profile_and_debug_nans_under_a_mesh(tmp_path, pools):
    """Two ranks (2 x 1) train one epoch (4 steps, a validation image and
    a checkpoint) with ``debug_nans`` and a 1-step trace window, then
    resume for a second epoch: step 8, the parameters of one rank's
    straight 2-epoch run (rtol 1e-4, atol 1e-5), and one trace (rank 0's)."""
    epoch = ["--max-steps", "100", *CFG[:-2], "trainer.mesh_data=2",
             "trainer.check_val_every_n_epoch=1",
             "trainer.limit_val_images=1"]
    pool = pools(2)
    first = pool.run("tests.torch_parallel_ranks:cli_train", epoch + [
        "--device", "cpu", "trainer.max_epochs=1", "trainer.debug_nans=true",
        f"trainer.profile_dir={tmp_path}/prof", "trainer.profile_steps=1",
        f"trainer.ckpt_dir={tmp_path}/part", f"trainer.log_dir={tmp_path}/a"])
    assert first[0]["step"] == 4
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json"))) == 1
    got = pool.run("tests.torch_parallel_ranks:cli_train", epoch + [
        "--device", "cpu", "trainer.max_epochs=2",
        f"trainer.resume={tmp_path}/part",
        f"trainer.ckpt_dir={tmp_path}/resumed",
        f"trainer.log_dir={tmp_path}/b"])[0]
    assert got["step"] == 8
    straight = train_cli.main(
        ["--device", "cpu", "--max-steps", "100", *CFG[:-2],
         "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=10",
         f"trainer.ckpt_dir={tmp_path}/straight",
         f"trainer.log_dir={tmp_path}/c"])
    assert straight.step == 8
    want = jax_from_state_dict(straight.task.net.state_dict())
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


class _Indexed:
    """Samples that carry their index and their generator's first draw."""

    def __len__(self):
        return 13

    def sample(self, idx, rng):
        return {2: (np.full((1, 1, 1), idx, np.float32),
                    np.full((1, 1, 1), rng.random(), np.float32))}


@pytest.mark.parametrize("num_shards", [2, 3, 4])
def test_host_sharding_order_matches_jax(num_shards):
    for shard in range(num_shards):
        kw = dict(batch_size=2, epoch=1, seed=5, repeat=2,
                  shard_index=shard, num_shards=num_shards)
        got = list(tpipe.train_batches(_Indexed(), num_workers=0, **kw))
        want = list(jpipe.train_batches(_Indexed(), num_workers=1, **kw))
        assert len(got) == len(want) == 26 // (2 * num_shards)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[2][0], b[2][0])
            np.testing.assert_array_equal(a[2][1], b[2][1])


@pytest.mark.parametrize("data,space,world,want", [
    (-1, 1, 1, (1, 1)), (-1, 2, 4, (2, 2)), (2, 2, 4, (2, 2)),
    (1, 0, 1, (1, 1)), (-1, 4, 4, (1, 4)), (4, 1, 4, (4, 1)),
])
def test_mesh_shape_follows_jax_rules(data, space, world, want):
    assert mesh_shape(data, space, world) == want


@pytest.mark.parametrize("data,space,world", [
    (-1, 2, 1), (2, 1, 1), (-1, 3, 4), (2, 4, 4), (1, 2, 4), (0, 1, 1)])
def test_mesh_shape_not_using_every_rank_raises(data, space, world):
    with pytest.raises(ValueError):
        mesh_shape(data, space, world)


@pytest.mark.parametrize("extra", [["trainer.mesh_space=2"],
                                   ["trainer.mesh_data=2"]])
def test_one_process_rejects_a_bigger_mesh(tmp_path, extra):
    """ROADMAP C6: the trainer read neither field and trained on one
    device; now a layout the world cannot hold raises before training."""
    with pytest.raises(ValueError, match="rank|world"):
        train_cli.main(_args(tmp_path, "bad", extra))
    assert not (tmp_path / "log_bad").exists()

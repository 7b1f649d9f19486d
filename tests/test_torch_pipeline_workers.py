"""The training sample workers of ``data/pipeline.py``: forked by one
forkserver that outlives each epoch's pool (so only the process's first
pool pays for the imports), and making the bytes the calling process
makes with ``num_workers=0``; also inside the spawned ranks of a
``RankPool``, each of which starts a server of its own."""

import os

import numpy as np

from tpu_diinn_torch.data import pipeline
from tpu_diinn_torch.data.datasets import SyntheticSRDataset
from tpu_diinn_torch.parallel.launch import RankPool


SCALES = (2, 3)


class ParentProbe(SyntheticSRDataset):
    """A synthetic set whose every sample also carries the pid of the
    process that forked or spawned its maker (exact in float32)."""

    def sample(self, idx, rng=None):
        out = super().sample(idx, rng)
        ppid = np.full((1, 1, 3), os.getppid(), np.float32)
        return {**out, 0: (ppid, ppid, "ppid")}


def test_workers_fork_from_one_server_and_make_the_same_bytes():
    ds = ParentProbe(n_images=6, image_size=32, scales=SCALES, patch_size=8,
                     seed=4)
    parents = set()
    for epoch in (0, 1):
        got = list(pipeline.train_batches(ds, batch_size=2, epoch=epoch,
                                          seed=3, num_workers=2))
        want = list(pipeline.train_batches(ds, batch_size=2, epoch=epoch,
                                           seed=3, num_workers=0))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for s in SCALES:
                for a, b in zip(g[s], w[s]):
                    np.testing.assert_array_equal(a, b)
            parents.update(int(p) for p in np.unique(g[0][0]))
    # both epochs' workers come from one server, not from this process
    assert len(parents) == 1 and os.getpid() not in parents


def test_workers_in_each_rank_make_its_shard():
    """Two gloo ranks, each iterating its shard of ``train_batches`` with
    two sample workers (as the trainer's ranks do under ``mesh_data=2``):
    each rank's workers fork from a server of that rank's (neither the
    rank nor this process), and each shard's bytes equal this process's
    ``num_workers=0`` shard."""
    ds = ParentProbe(n_images=8, image_size=32, scales=SCALES, patch_size=8,
                     seed=5)
    with RankPool(2, threads=1) as pool:
        got = pool.run("tests.torch_parallel_ranks:shard_batches", ds, 2, 1,
                       3, 2)
    servers = []
    for rank, (pid, batches) in enumerate(got):
        want = list(pipeline.train_batches(
            ds, batch_size=2, epoch=1, seed=3, num_workers=0,
            shard_index=rank, num_shards=2))
        assert len(batches) == len(want) == 2
        for g, w in zip(batches, want):
            for s in SCALES:
                for a, b in zip(g[s], w[s]):
                    np.testing.assert_array_equal(a, b)
        parents = {int(p) for b in batches for p in np.unique(b[0][0])}
        assert len(parents) == 1 and not parents & {pid, os.getpid()}
        servers.append(parents.pop())
    assert servers[0] != servers[1]

"""Local ranks: spawn a process group on one host and run functions on it.

``RankPool(world)`` starts ``world`` processes (``spawn``), each with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR=localhost``, ``MASTER_PORT``) and joined through
``mesh.maybe_init_distributed``; they stay up between calls, so that a
suite of small multi-rank checks pays the start-up once.
``pool.run("package.module:function", *args)`` calls the function on
every rank at once and returns its results by rank (each picklable); an
exception on any rank stops the pool and raises with that rank's
traceback (the other ranks may be waiting in a collective). The next
``run`` starts a fresh pool.

The ranks are not daemons, so that they may start processes of their own
(the trainer's sample workers); ``close()``, or leaving the pool's
``with`` block, stops them.

``share_device=True`` gives every rank ``LOCAL_RANK=0``: several ranks on
one card, which NCCL refuses and gloo serves (``mesh.py`` stages its
collectives through the host).
"""

from __future__ import annotations

import importlib
import multiprocessing
from multiprocessing import connection
import os
import socket
import traceback
from typing import Any, List, Optional


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank: int, world: int, port: int, local_rank: int,
           device_type: str, backend: Optional[str], threads: int,
           conn) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch
    torch.set_num_threads(threads)
    from tpu_diinn_torch.parallel.mesh import maybe_init_distributed
    try:
        maybe_init_distributed(device_type, backend)
        conn.send(("ok", None))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        target, args, kwargs = msg
        try:
            mod, _, fn = target.partition(":")
            result = getattr(importlib.import_module(mod), fn)(*args,
                                                               **kwargs)
            conn.send(("ok", result))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int, *, device_type: str = "cpu",
                 backend: Optional[str] = None, threads: int = 1,
                 share_device: bool = False, timeout: float = 600.0):
        self.world = world
        self.kw = dict(device_type=device_type, backend=backend,
                       threads=threads)
        self.share_device = share_device
        self.timeout = timeout
        self.procs: List[Any] = []
        self.conns: List[Any] = []

    def start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        for r in range(self.world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, args=(
                r, self.world, port, 0 if self.share_device else r,
                self.kw["device_type"], self.kw["backend"],
                self.kw["threads"], child))
            p.start()
            self.procs.append(p)
            self.conns.append(parent)
        self._collect("process group start-up")

    def _collect(self, what: str) -> list:
        results = [None] * self.world
        pending = set(range(self.world))
        while pending:
            ready = connection.wait(
                [self.conns[r] for r in pending], timeout=self.timeout)
            if not ready:
                self.close(kill=True)
                raise TimeoutError(f"{what}: ranks {sorted(pending)} gave "
                                   f"no answer in {self.timeout} s")
            for r in list(pending):
                if self.conns[r] in ready:
                    try:
                        status, value = self.conns[r].recv()
                    except EOFError:
                        status, value = "err", "the process ended"
                    if status != "ok":
                        self.close(kill=True)
                        raise RuntimeError(f"{what}: rank {r} failed:\n"
                                           f"{value}")
                    results[r] = value
                    pending.discard(r)
        return results

    def run(self, target: str, *args, **kwargs) -> list:
        """``target``'s results on every rank, by rank."""
        if not self.procs:
            self.start()
        for c in self.conns:
            c.send((target, args, kwargs))
        return self._collect(target)

    def close(self, kill: bool = False) -> None:
        """Stop the ranks (at once with ``kill``: after a failure the
        others may be waiting in a collective)."""
        for c in self.conns:
            try:
                c.send(None)
            except (OSError, BrokenPipeError):
                pass
        for p in self.procs:
            p.join(timeout=0 if kill else 10)
            if p.is_alive():
                p.kill()
                p.join()
        self.procs, self.conns = [], []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

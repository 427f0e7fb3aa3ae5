"""Spawned rank processes for the port's multi-rank runs.

`RankPool(n, device, workdir)` starts n processes (spawn, not fork) that
each wait for jobs. `pool.run(fn, world, *args)` makes ranks 0..world-1
join a fresh process group (a file:// store under `workdir`, so no port
is taken), call the module-level `fn(device, *args)` and leave the group
again; it returns the ranks' results in rank order and raises as soon
as a rank fails (`start` and `wait` split it, so the caller can work
while the ranks do). One pool serves runs of several world sizes and
backends, so a process's start (imports, CUDA context) is paid once.

Every rank of a pool sits on `comm.rank_device(device, rank)`: on a
host with one GPU all ranks share cuda:0, and `comm.choose_backend`
then picks gloo for world > 1 and NCCL for a world of 1.
"""
from __future__ import annotations

import itertools
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import comm


def _worker(rank: int, device: str, threads: int, jobs, results):
    torch.set_num_threads(threads)
    while True:
        job = jobs.get()
        if job is None:
            return
        fn, world, init_method, args = job
        try:
            _, _, dev = comm.init_from_env(
                device=device, rank=rank, world=world, local_rank=rank,
                local_world=world, init_method=init_method)
            out = fn(dev, *args)
            dist.destroy_process_group()
            results.put((rank, True, out))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
            raise
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()


class RankPool:
    """`size` spawned rank processes on `device` (see the module doc)."""

    def __init__(self, size: int, device: str = "cuda", workdir: str = ".",
                 threads: int = 1, timeout: float = 900.0):
        ctx = mp.get_context("spawn")
        self.size, self.workdir, self.timeout = size, workdir, timeout
        self._jobs = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, device, threads, self._jobs[r],
                                         self._results))
                       for r in range(size)]
        self._stores = itertools.count()
        self._closed = False
        for p in self._procs:
            p.start()

    def run(self, fn, world: int | None = None, *args) -> list:
        """fn(device, *args) on ranks 0..world-1 (default: every process)
        of a new process group; the results in rank order."""
        self.start(fn, world, *args)
        return self.wait()

    def start(self, fn, world: int | None = None, *args):
        """`run` without waiting: the caller may work meanwhile, then
        takes the results with `wait`."""
        world = self.size if world is None else world
        if not 1 <= world <= self.size:
            raise ValueError(f"world {world} outside 1..{self.size}")
        store = os.path.abspath(os.path.join(
            self.workdir, f"store-{os.getpid()}-{next(self._stores)}"))
        for r in range(world):
            self._jobs[r].put((fn, world, "file://" + store, args))
        self._started = (fn.__name__, world)

    def wait(self) -> list:
        """The started job's results in rank order; raises as soon as a
        rank fails or exits, or when the pool's timeout passes."""
        name, world = self._started
        out = [None] * world
        deadline = time.monotonic() + self.timeout
        for _ in range(world):
            while True:
                try:
                    rank, ok, value = self._results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs[:world])
                            if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self.close()
                        raise RuntimeError(
                            f"{name}: ranks {dead} exited without a "
                            f"result" if dead else f"{name}: no result "
                            f"within {self.timeout} s") from None
            if not ok:
                self.close()
                raise RuntimeError(f"{name} failed on rank {rank}:\n"
                                   f"{value}")
            out[rank] = value
        return out

    def close(self):
        """Stop every process (those still busy are terminated). Jobs a
        rank never took are dropped, so the caller does not wait at its
        exit to hand them over."""
        if self._closed:
            return
        self._closed = True
        for q, p in zip(self._jobs, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        for q in self._jobs + [self._results]:
            q.cancel_join_thread()
            q.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

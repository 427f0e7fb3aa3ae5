"""The per-job callable of a cell on several cards: one pmvs3 job on the
port's engine mesh, and the lifetime of the ranks that run it.

`Ranks(world, device, workdir, args)` makes the harness's own process
rank 0 of a process group of `world` ranks and spawns ranks 1..world-1,
one process a card for the whole run (NCCL on CUDA, one card a rank;
gloo on the CPU). `Ranks.job(label, tree)` is the window's per-job
callable: it hands the job to every other rank, runs
`reconstruct(tree, OPTION, device=<rank 0's card>,
mesh=make_engine_mesh())` as rank 0 (which writes the three files), as
`torchrun ... -m cmvs_pmvs_tpu_torch.cli.pmvs` does on every rank, and
returns once every rank has returned: the record holds rank 0's engine,
each rank's `time.monotonic()` at its return (`rank_ends`) and the
other ranks' peak of reserved memory (`peak`); the seconds run from the
dispatch to the last rank's return. `Ranks.window(trace)` marks the
measured window (with `trace`, every other rank profiles its jobs in it;
`busy_us()` then gives each one's device-busy microseconds);
`Ranks.stop()` ends and joins the ranks.

A job that fails on every rank alike (the ranks' states disagree, say)
is a failed job, and the next job runs. A rank that dies, or that does
not return while the others wait, leaves the group out of step: the job
raises `RanksLost`, which ends the window. Where rank 0 itself waits in a
collective for a rank that failed or died, or a job passes its deadline,
a watchdog thread ends the run: it stops the ranks, calls `lost` (which
prints the run's result line, `correct` false) and exits the process
with code 1, since a collective on the card cannot be interrupted.
"""
from __future__ import annotations

import contextlib
import os
import queue
import sys
import threading
import time
import traceback

import torch
import torch.multiprocessing as mp

from mvsbench import profiling
from mvsbench.tree import OPTION

# a job's deadline in seconds: in set-up (the first run of a checkout
# builds the kernels there) and in the window
SETUP_DEADLINE = 900.0
JOB_DEADLINE = 120.0
# how long rank 0 may stay inside a job once another rank has failed or
# died, before the watchdog ends the run
GRACE = 20.0


class RanksLost(RuntimeError):
    """A rank died or fell out of step: no later job can run. `final`
    tells the window loop to end the window."""
    final = True


def _quiet(*parts):
    """The engine's log: not printed."""


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank(rank: int, world: int, init: str, device: str, threads: int,
          fault, jobs, replies):
    """A spawned rank: join the group, then run each job message until
    None. A job's reply: ok, the `time.monotonic()` at its return and the
    peak of reserved memory since the last reply; ("trace", True) starts
    profiling the following jobs, ("trace", False) stops it and replies
    the device-busy microseconds over the profiled jobs."""
    torch.set_num_threads(threads)
    import torch.distributed as dist
    from cmvs_pmvs_tpu_torch.models import engine as E
    from cmvs_pmvs_tpu_torch.parallel.comm import init_from_env
    from cmvs_pmvs_tpu_torch.parallel.engine_shard import make_engine_mesh
    if fault is not None:
        fault()
    _, _, dev = init_from_env(device=device, rank=rank, world=world,
                              local_rank=rank, local_world=world,
                              init_method=init)
    cuda = dev.type == "cuda"
    prof = None
    while True:
        msg = jobs.get()
        if msg is None:
            break
        if msg[0] == "trace":
            if msg[1]:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) if cuda else None
                if prof is not None:
                    prof.start()
                continue
            busy = 0.0
            if prof is not None:
                prof.stop()
                evts = profiling.events(prof)
                jobs_ = [e for e in evts if e.kind == profiling.SPAN
                         and e.name == "mvsbench.job"]
                if jobs_:
                    busy = profiling.busy_us(evts, jobs_[0].start,
                                             jobs_[-1].end)
                prof = None
            replies.put({"rank": rank, "busy_us": busy})
            continue
        _, root, args = msg
        reply = {"rank": rank, "ok": True, "error": None}
        try:
            with torch.profiler.record_function("mvsbench.job"):
                E.reconstruct(root, OPTION, log=_quiet, device=dev,
                              mesh=make_engine_mesh(), **args)
                _sync(dev)
        except Exception:   # reported; the harness decides what follows
            reply.update(ok=False, error=traceback.format_exc())
        reply["end"] = time.monotonic()
        reply["peak"] = torch.cuda.max_memory_reserved(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        replies.put(reply)
    dist.destroy_process_group()


class Ranks:
    """The harness as rank 0 of `world` ranks, the others spawned (see
    the module doc). `args` are the traffic's `reconstruct` arguments;
    `fault` (faults.py) is planted in every spawned rank; `lost(reason,
    attempted, failed)` prints the result of a run the watchdog ends."""

    def __init__(self, world: int, device, workdir: str, args: dict,
                 fault=None, lost=None, threads: int = 4):
        from cmvs_pmvs_tpu_torch.parallel.comm import init_from_env
        ctx = mp.get_context("spawn")
        self.args, self.lost = args, lost
        self.attempted = self.failed = 0
        self._traced = False
        self._deadline = SETUP_DEADLINE
        self._in_window = False
        self._inside = None     # when rank 0 entered its part of a job
        self._failed_at = None  # when a rank replied that the job failed
        self._lost = None       # why the ranks are out of step, for good
        self._got: dict = {}    # the current job's replies by rank
        self._cond = threading.Condition()
        self._closing = self._closed = False
        init = "file://" + os.path.join(os.path.abspath(workdir),
                                        "mesh-store")
        self._replies = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(world - 1)]
        self._procs = [ctx.Process(
            target=_rank, daemon=True,
            args=(r, world, init, device.type, threads, fault,
                  self._jobs[r - 1], self._replies))
            for r in range(1, world)]
        for p in self._procs:
            p.start()
        self._watchdog = threading.Thread(target=self._watch, daemon=True)
        self._watchdog.start()
        self._inside = time.monotonic()     # joining the group
        _, _, self.device = init_from_env(
            device=str(device), rank=0, world=world, local_rank=0,
            local_world=world, init_method=init)
        self._inside = None

    # ---- the per-job callable ----

    def job(self, label: str, root: str):
        """One job on every rank: ({"engine": rank 0's engine,
        "rank_ends", "peak"}, seconds from the dispatch to the last
        rank's return)."""
        if self._in_window:
            self.attempted += 1
        try:
            return self._job(root)
        except Exception:
            if self._in_window:
                self.failed += 1
            raise

    def _job(self, root: str):
        from cmvs_pmvs_tpu_torch.models import engine as E
        from cmvs_pmvs_tpu_torch.parallel.engine_shard import \
            make_engine_mesh
        if self._lost is not None:
            raise RanksLost(self._lost)
        with self._cond:
            self._got.clear()
            self._failed_at = None
        t = time.perf_counter()
        for q in self._jobs:
            q.put(("job", root, self.args))
        err = eng = None
        self._inside = time.monotonic()
        try:
            eng = E.reconstruct(root, OPTION, log=_quiet, device=self.device,
                                mesh=make_engine_mesh(), **self.args)
            _sync(self.device)
        except Exception as e:      # the other ranks' replies come first
            err = e
        finally:
            end = time.monotonic()
            self._inside = None
        got = self._wait(lambda got: len(got) == len(self._jobs), GRACE
                         if err is not None else
                         t + self._deadline - time.perf_counter())
        seconds = time.perf_counter() - t
        if err is not None:
            raise err
        bad = [r for r in got.values() if not r["ok"]]
        if bad:
            raise RuntimeError(f"rank {bad[0]['rank']} failed:\n"
                               f"{bad[0]['error']}")
        ranks = [got[r] for r in sorted(got)]
        return {"engine": eng, "rank_ends": [end] + [r["end"] for r in ranks],
                "peak": max((r["peak"] for r in ranks), default=0)}, seconds

    def _wait(self, done, timeout: float) -> dict:
        """The replies once `done(replies)`; RanksLost if a rank dies or
        `timeout` passes first."""
        until = time.monotonic() + max(timeout, 0.0)
        with self._cond:
            while not done(self._got):
                if self._lost is None and time.monotonic() > until:
                    self._lost = "a rank did not reply within its deadline"
                if self._lost is not None:
                    raise RanksLost(self._lost)
                self._cond.wait(1.0)
            return dict(self._got)

    # ---- the ranks' lifetime ----

    @contextlib.contextmanager
    def window(self, trace: bool):
        """The measured window: jobs count as attempted, each has the
        window's deadline, and with `trace` every other rank profiles its
        jobs (`busy_us` reads them afterwards)."""
        self._in_window, self._deadline = True, JOB_DEADLINE
        self._traced = trace
        if trace:
            for q in self._jobs:
                q.put(("trace", True))
        try:
            yield self
        finally:
            self._in_window = False
            if trace and self._lost is None:
                with self._cond:
                    self._got.clear()
                for q in self._jobs:
                    q.put(("trace", False))

    def busy_us(self) -> list[float]:
        """After a traced window: each other rank's device-busy
        microseconds over its window jobs, in rank order."""
        if not self._traced or self._lost is not None:
            return []
        got = self._wait(lambda got: len(got) == len(self._jobs),
                         JOB_DEADLINE)
        return [got[r]["busy_us"] for r in sorted(got)]

    def stop(self):
        """End every rank, leaving the group with them, and wait for it
        (one that does not end is killed)."""
        import torch.distributed as dist
        if self._closed:
            return
        self._closing = True
        for q, p in zip(self._jobs, self._procs):
            if p.is_alive():
                q.put(None)
        if dist.is_initialized() and self._lost is None:
            dist.destroy_process_group()
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._closed = True
        self._watchdog.join(timeout=5)
        for q in self._jobs + [self._replies]:
            q.cancel_join_thread()
            q.close()

    def _watch(self):
        """Take the ranks' replies, note a rank that failed or died, and
        end the run where rank 0 cannot get out of a job (module doc)."""
        while not self._closed:
            try:
                reply = self._replies.get(timeout=0.5)
            except (queue.Empty, OSError, ValueError):
                reply = None
            now = time.monotonic()
            with self._cond:
                if reply is not None:
                    self._got[reply["rank"]] = reply
                    if not reply.get("ok", True):
                        self._failed_at = self._failed_at or now
                dead = [r + 1 for r, p in enumerate(self._procs)
                        if p.exitcode is not None]
                if dead and not self._closing and self._lost is None:
                    self._lost = f"rank processes {dead} exited"
                    self._failed_at = self._failed_at or now
                self._cond.notify_all()
            inside, trouble = self._inside, self._failed_at
            if inside is None or self._closing:
                continue
            if now - inside > self._deadline:
                self._end(f"rank 0 still in a job after {self._deadline} s")
            if trouble is not None and now - max(trouble, inside) > GRACE:
                self._end(f"rank 0 still in a job {GRACE} s after another "
                          f"rank failed: {self._lost or 'an error'}")

    def _end(self, reason: str):
        """Stop the ranks, report the run through `lost` and exit."""
        print(f"mvsbench.mesh: {reason}", file=sys.stderr, flush=True)
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        if self.lost is not None:
            self.lost(reason, self.attempted, self.failed + 1)
        sys.stdout.flush()
        os._exit(1)

"""Faults planted in the program underneath a run, for the benchmark's
tests and for the fault readings of `control.py`: each breaks the timed
path in one way a check has to catch. Each is a callable that breaks the
program in this process and returns the callable that undoes it."""
from __future__ import annotations


def unchanged():
    """Expansion returns the cloud unchanged: the seeds alone go on."""
    from cmvs_pmvs_tpu_torch.models import engine as E
    orig = E.PMVSEngine._expand_round

    def same(self, it, max_waves, refine_iters):
        return self._read(self.cloud.count())[0], 0, 0

    E.PMVSEngine._expand_round = same
    return lambda: setattr(E.PMVSEngine, "_expand_round", orig)


def half_written():
    """The written files leave out every second patch."""
    from cmvs_pmvs_tpu_torch.models import engine as E
    saved = {k: getattr(E, k) for k in ("write_patch_arrays",
                                        "write_patch_ply", "write_pset")}

    def halve(fn):
        def call(path, *arrays, **kw):
            return fn(path, *[a[::2] for a in arrays],
                      **{k: v[::2] for k, v in kw.items()})
        return call

    for k, fn in saved.items():
        setattr(E, k, halve(fn))
    return lambda: [setattr(E, k, fn) for k, fn in saved.items()]


def moved():
    """Every patch is moved by two depth scales along its normal where
    the engine hands its cloud to the writers."""
    from cmvs_pmvs_tpu_torch.models import engine as E
    orig = E.PMVSEngine.write

    def write(self, prefix, **kw):
        c = self.cloud
        shift = 2.0 * c.dscale[:, None] * c.normal
        self.cloud = type(c)(**{**c.__dict__, "coord": c.coord + shift})
        return orig(self, prefix, **kw)

    E.PMVSEngine.write = write
    return lambda: setattr(E.PMVSEngine, "write", orig)


def pixel():
    """Loading alters one pixel of every image's pyramid."""
    from dataclasses import replace
    from cmvs_pmvs_tpu_torch.models import engine as E
    orig = E.load_scene

    def load(*args, **kw):
        sc = orig(*args, **kw)
        atlas = sc.pyr.atlas.clone()
        atlas[:, 30, 40, 0] = (atlas[:, 30, 40, 0] + 1) % 256
        return replace(sc, pyr=replace(
            sc.pyr, atlas=atlas, atlas_k=atlas.to(sc.pyr.atlas_k.dtype)))

    E.load_scene = load
    return lambda: setattr(E, "load_scene", orig)


def own_rows():
    """The engine mesh's row all-gather (`engine_shard.gather_rows`,
    after seeding, in discovery and in every filter stage) leaves the
    exchange out: each rank's whole result holds its own rows in every
    rank's place. The collectives still run, so the ranks stay in step."""
    import torch
    from cmvs_pmvs_tpu_torch.parallel import engine_shard as S
    orig = S.gather_rows

    def gather(mesh, tensors):
        whole = orig(mesh, tensors)
        own = tensors[0].shape[0]
        if own == 0:
            return [torch.zeros_like(w) for w in whole]
        return [torch.cat([t] * -(-w.shape[0] // own))[:w.shape[0]]
                for t, w in zip(tensors, whole)]

    S.gather_rows = gather
    return lambda: setattr(S, "gather_rows", orig)


def rank_dies():
    """On an engine mesh every rank but rank 0 dies (its process exits)
    as its expansion starts: the run has to end with a failed job."""
    import os

    import torch.distributed as dist
    from cmvs_pmvs_tpu_torch.models import engine as E
    orig = E.PMVSEngine._expand_round

    def die(self, *args, **kwargs):
        if dist.get_rank() != 0:
            os._exit(1)
        return orig(self, *args, **kwargs)

    E.PMVSEngine._expand_round = die
    return lambda: setattr(E.PMVSEngine, "_expand_round", orig)


def rank_hangs():
    """On an engine mesh every rank but rank 0 stops (sleeps for ten
    minutes) as its expansion starts, while rank 0 waits for it in a
    collective: the run has to end with a failed job, not hang."""
    import time

    import torch.distributed as dist
    from cmvs_pmvs_tpu_torch.models import engine as E
    orig = E.PMVSEngine._expand_round

    def stop(self, *args, **kwargs):
        if dist.get_rank() != 0:
            time.sleep(600)
        return orig(self, *args, **kwargs)

    E.PMVSEngine._expand_round = stop
    return lambda: setattr(E.PMVSEngine, "_expand_round", orig)


FAULTS = {"unchanged": unchanged, "half_written": half_written,
          "moved": moved, "pixel": pixel, "own_rows": own_rows,
          "rank_dies": rank_dies, "rank_hangs": rank_hangs}

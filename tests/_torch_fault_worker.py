"""Subprocess worker of tests/test_torch_fault.py: the port's cluster
scheduler in a process of its own, so that a test can SIGKILL it.

    python tests/_torch_fault_worker.py clusters <prefix> <device>
    python tests/_torch_fault_worker.py cli <prefix> [pmvs3_all args]

`clusters` runs `run_clusters(checkpoint=True)` over every cluster of
<prefix> on <device>, as one pmvs3_all process does; `cli` runs
`cli.pmvs_all.main` itself (under torchrun, each rank its share). Both
cut the reconstruction to tests/test_fault.py's size (p_cap 8192, one
expand round of one wave, 4 LM iterations), and both wrap
`engine.reconstruct` in this process so that it writes this process's
pid to <prefix>/started-<name> before each cluster: a test that kills
on that file kills a process whose cluster is reconstructing, with no
switch in the program. Imports neither jax nor the JAX package.
"""
import os
import sys

import torch

torch.set_num_threads(1)

import cmvs_pmvs_tpu_torch.models.engine as engine  # noqa: E402

SIZE = dict(p_cap=8192, expand_iters=1, max_waves=1, refine_iters=4)


def _wrap_reconstruct():
    full = engine.reconstruct

    def started(prefix, name, **kw):
        with open(os.path.join(prefix, "started-" + name), "w") as f:
            f.write(f"{os.getpid()}\n")
        kw.update(SIZE)
        return full(prefix, name, **kw)
    engine.reconstruct = started


def main(argv) -> int:
    mode, prefix, rest = argv[0], argv[1], argv[2:]
    _wrap_reconstruct()
    if mode == "clusters":
        from cmvs_pmvs_tpu_torch.parallel.clusters import run_clusters
        runs = run_clusters(prefix, process_index=0, process_count=1,
                            checkpoint=True, device=rest[0], log=print)
        print(" ".join(f"{r.name}:{r.patches}" for r in runs), flush=True)
        return 0
    if mode == "cli":
        from cmvs_pmvs_tpu_torch.cli import pmvs_all
        return pmvs_all.main([prefix, *rest])
    raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

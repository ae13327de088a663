"""Repeat the 4-rank atlas-sharded step of ``tests/test_torch_parallel.py``
on the CPU and count the runs whose texture after one Adam step leaves the
single-device step's by more than the test's 1e-4, at a given number of
intra-op threads per rank.

    python tools/torch_parallel_threads.py --threads 4 --runs 20 [--warm_sqrt]

``--warm_sqrt`` calls ``torch.sqrt`` once on one thread in each rank before
the step. Each run prints its largest texture gap, the ranks whose Adam
step gave a wrong texel and, for those, where the wrong entries lie and
the gradient's gap to the reference's there. Needs JAX (the test's inputs
come from the JAX package); works in a temporary directory.
"""

import argparse
import multiprocessing
import os
import sys
import tempfile
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from stylemesh_tpu_torch.parallel.mesh import make_mesh, shutdown  # noqa: E402
from tests import torch_parallel_worker as worker  # noqa: E402

WORLD = 4


def _rank(rank, directory, tag, threads, warm_sqrt):
    torch.set_num_threads(1 if warm_sqrt else threads)
    if warm_sqrt:
        torch.ones(4096).sqrt()
        torch.set_num_threads(threads)
    out = {}
    try:
        mesh = make_mesh(WORLD, rank, "cpu", init_method="file://"
                         + os.path.join(directory, f"store_{tag}"),
                         timeout_s=worker.TIMEOUT_S)
        inputs = torch.load(os.path.join(directory, "inputs.pt"),
                            weights_only=False)
        try:
            worker._atlas(mesh, inputs, "atlas", out)
        finally:
            shutdown(mesh)
    except BaseException:  # reported by the parent, which raises
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(directory, f"{tag}_rank{rank}.pt"))


def _run(directory, tag, threads, warm_sqrt):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, directory, tag, threads,
                                             warm_sqrt)) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(worker.TIMEOUT_S)
    outs = [torch.load(os.path.join(directory, f"{tag}_rank{r}.pt"),
                       weights_only=False) for r in range(WORLD)]
    for out in outs:
        if "error" in out:
            raise RuntimeError(out["error"])
    return [out["atlas"] for out in outs]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--warm_sqrt", action="store_true")
    args = p.parse_args()

    from tests.test_torch_parallel import _inputs, _port_single

    with tempfile.TemporaryDirectory() as tmp:
        inputs = _inputs(Path(tmp))
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        grads, _, layers = _port_single(inputs)
        failed = 0
        for run in range(args.runs):
            parts = _run(tmp, f"run{run}", args.threads, args.warm_sqrt)
            worst, notes = 0.0, []
            for l, want in enumerate(layers):
                band = np.concatenate([q["bands"][l] for q in parts])
                worst = max(worst, float(np.abs(band - want).max()))
                h = band.shape[0] // WORLD
                for r, q in enumerate(parts):
                    w, g = want[r * h:(r + 1) * h], grads[l][r * h:(r + 1) * h]
                    bad = np.abs(q["bands"][l] - w) > 1e-4
                    if bad.any():
                        flat = np.flatnonzero(bad)
                        notes.append(
                            f"rank {r} layer {l}: {bad.sum()} of {bad.size} "
                            f"entries, flat {flat.min()}..{flat.max()}, "
                            f"gradient gap {np.abs(q['grads'][l] - g)[bad].max():.3g}")
            failed += worst > 1e-4
            print(f"run {run}: threads {args.threads}, warm_sqrt "
                  f"{args.warm_sqrt}, max texture gap {worst:.4g}"
                  + "".join(f"\n  {n}" for n in notes), flush=True)
        print(f"{failed} of {args.runs} runs beyond 1e-4 (threads "
              f"{args.threads}, warm_sqrt {args.warm_sqrt})")


if __name__ == "__main__":
    main()

"""Time the PyTorch port's bench train step of one checkout on one CUDA card:
the step, and the device time of the sampling kernels and of the float32
adds in one profiled step.

    python3 tools/torch_step_ab.py [--root CHECKOUT] [--steps N]

``--root`` (default: the checkout holding this file) is put first on the
import path, so ``stylemesh_tpu_torch`` and its ``chip_smoke.py`` come from
there, and its kernels are built into its own ``build/torch_ext``. Running
it on two checkouts in turns (A B B A), each in its own process on one
card, compares two commits (each must have ``chip_smoke.bench_workload``).
The workload is ``chip_smoke.py``'s bench step (V = 4, 4096^2 x 4 atlas, UV
levels 256..784, bf16 VGG, float32 K1/K2, Adam), 2 warm-up steps, then ``--steps`` timed steps (host clock ending in
a synchronize), then one step under ``torch.profiler``. Prints one JSON
line; exits nonzero without CUDA.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_step_ab: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import bench_workload

    pipe, batch = bench_workload()
    state = pipe.init()
    aux = pipe.prepare_batch(batch)
    for _ in range(2):
        pipe.train_step(state, batch, aux)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        pipe.train_step(state, batch, aux)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.train_step(state, batch, aux)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]

    def device_ms(match):
        rows = [e for e in on_device if match(e.key)]
        return (sum(e.self_device_time_total for e in rows) / 1e3,
                sum(e.count for e in rows))

    gather = device_ms(lambda k: k.startswith(("void gather_kernel<",
                                               "gather_kernel<")))
    splat = device_ms(lambda k: k.startswith(("void splat_kernel<",
                                              "splat_kernel<")))
    adds = device_ms(lambda k: "CUDAFunctor_add<float>" in k)
    busy = sum(e.self_device_time_total for e in on_device) / 1e3
    print(json.dumps({
        "root": args.root, "device": torch.cuda.get_device_name(0),
        "step_ms": step_ms, "views_per_s": 4 * 1e3 / step_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profiled_busy_ms": busy,
        "k1_ms": gather[0], "k1_launches": gather[1],
        "k2_ms": splat[0], "k2_launches": splat[1],
        "float32_add_ms": adds[0], "float32_add_launches": adds[1]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

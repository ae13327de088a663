"""Run one cell of the benchmark on this machine's CUDA card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted`` (steps in the window),
``failed`` (steps with a non-finite loss), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s`` of the profiled
stretch), with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit, which also end
standard error. Exits nonzero, printing no result, without a card or with
fewer than the cell asks for, or when ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``stylemesh_tpu`` was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "stylemesh_tpu")
TOP = 10  # entries of each breakdown list


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each module's name up to its first dot compared
    whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_metric(name, bench_dir):
    """The reader ``<bench_dir>/metrics/<name>.py``."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_cell(cell, seed, seconds, trace, device, t_start, bench_dir=None,
             log=print):
    """One run of ``cell``; returns the result object (without the JAX
    check, which the caller makes)."""
    import torch

    from benchmark import check, harness

    bench_dir = bench_dir or harness.BENCH_DIR
    device = torch.device(device)
    cuda = device.type == "cuda"
    with harness.workdir() as wd:
        session = harness.Session(cell, seed, device, wd)
        if trace and cuda:
            harness.warm_profiler(device)
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        counts0 = launch_counts()
        setup_s = time.perf_counter() - t_start
        record = harness.Record(session, setup_s)
        if trace:
            record.stretches = harness.measure_traced(session, seconds)
            steps = sum(s.steps for s in record.stretches.values())
        else:
            record.window = harness.measure(session, seconds)
            steps = record.window.steps
        failed = session.loop.failed
        counts = {k: v - counts0[k] for k, v in launch_counts().items()}
        log(f"[run] steps queued in each second of the last stretch "
            f"{session.loop.per_second}")
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        record.window_peak_bytes = window_peak
        name = torch.cuda.get_device_name(device) if cuda else "cpu"
        record.peaks = harness.load_peaks(name, bench_dir) if cuda else None
        kind = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in cell.metrics_of(kind):
            value = load_metric(m["name"], bench_dir).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
               "count": cell.chips,
               "memory_peak_bytes": max(setup_peak, window_peak)}
        result = {"correct": False, "attempted": steps, "failed": failed,
                  "metrics": metrics, "device": dev}
        if trace:
            tl = record.stretches["profiled"].timeline
            per_step = 1.0 / max(record.stretches["profiled"].steps, 1)
            dev["busy_s"], dev["window_s"] = tl.busy_s, tl.window_s
            result["breakdown"] = {
                "device_ops": top(tl.device_ops(), per_step),
                "idle_gaps": top(tl.idle_gaps(), per_step)}
        log("[run] set-up phases (s) " + json.dumps(session.phases))
        if trace:
            log(f"[trace] {tl.outside} device operations fell outside the "
                f"profiled stretch")
        log(f"[run] {cell.name} seed {seed}: setup {setup_s:.3f} s, "
            f"{steps} steps, launches {json.dumps(counts)}, peak device "
            f"memory set-up {setup_peak} window {window_peak} bytes")
        if trace:
            log("[trace] device seconds a step " + json.dumps(
                top(tl.device_ops(), per_step, None)))
        session.free()
        t0 = time.perf_counter()
        numbers = check.gaps(session.numbers, check.reference_numbers(
            session, harness.resolved(session.pipe_cfg)))
        log(f"[run] reference {time.perf_counter() - t0:.3f} s")
    result["correct"] = check.verdict(numbers, cell.limits) and failed == 0
    result["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                        for k in check.NUMBERS}
    log("[run] program " + json.dumps(check.printable(session.numbers)))
    log(f"[run] gaps (grad_gap not compared) {json.dumps(numbers)}")
    return result


def top(seconds_by_name, scale, n=TOP):
    """The ``n`` largest entries (all for None) as ``[name, seconds *
    scale]``."""
    items = sorted(seconds_by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v * scale] for k, v in items]


def launch_counts():
    """The launch counters of the port's kernel wrappers."""
    from stylemesh_tpu_torch.ops import (
        adam_kernels,
        conv_im2col,
        conv_kernels,
        gram_kernels,
        grid_sample,
        head_kernels,
    )

    counts = dict(grid_sample.launch_counts())
    counts["gram_fwd"] = gram_kernels.masked_gram_sums.launches
    counts["gram_bwd"] = gram_kernels.masked_gram_sums_grad.launches
    counts["conv3x3"] = conv_kernels.conv3x3.launches
    counts["conv3x3_mxu"] = conv_kernels.conv3x3_mxu.launches
    counts["conv_relu_pool"] = head_kernels.conv_relu_pool.launches
    counts["conv_relu_pool_dual"] = head_kernels.conv_relu_pool.dual_launches
    counts["conv_relu_pool_bwd"] = head_kernels.conv_relu_pool_bwd.launches
    counts["stem_fwd"] = conv_im2col.stem_forward.launches
    counts["stem_bwd"] = conv_im2col.stem_backward.launches
    counts["adam_clamp"] = adam_kernels.adam_clamp_.launches
    return counts


def card_info():
    """``nvidia-smi``'s name, power limit and clocks of the cards."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)  # the checkout, not this script's directory
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on one", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print(f"[card] {card_info()}", flush=True)
    result = run_cell(cell, args.seed, args.seconds, args.trace, "cuda",
                      T_START)
    print(f"[card] {card_info()}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were imported: {bad}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

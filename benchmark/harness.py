"""One run of one cell: set-up, the measured window over the port's chunk
loop, and the records its metrics read.

The loop is ``optimize.py::run_training``'s, written from the port's public
calls because ``run_training`` has no time-bounded entry: per chunk
``SceneCache.get_batch``, ``batch_from_numpy`` and
``TexturePipeline.prepare_batch``, then ``train_step`` for each of the
chunk's steps, each step's losses read one step late. Chunks come from the
port's sampler as ``run_training`` draws them, epoch after epoch.

Set-up (``setup_s``, from the process's start): the kernel library, the
cell's scene written from the seed into ``$TMPDIR`` and loaded by
``SceneCache``, the VGG weights made on the device from the seed, the style
image read, the pipeline built with ``run_training``'s static level skip,
and the first three steps of the loop, which warm every shape up and give
the numbers the reference checks (``check.py``). The same pipeline and
state go on into the window.
"""

import contextlib
import dataclasses
import json
import math
import os
import shutil
import tempfile
import time
from pathlib import Path

import torch

from benchmark import devtrace, work
from benchmark.scene import write_scene
from benchmark.reference.step import VGG_CONVS
from stylemesh_tpu_torch import kernels
from stylemesh_tpu_torch.convert import batch_from_numpy
from stylemesh_tpu_torch.data.loading import SceneCache
from stylemesh_tpu_torch.data.sampling import (
    batched,
    batched_repeat,
    epoch_indices,
    make_split,
)
from stylemesh_tpu_torch.models.pipeline import PipelineConfig, TexturePipeline
from stylemesh_tpu_torch.optimize import (
    RunConfig,
    discover_scene,
    load_style_image,
    scene_grad_dead_levels,
    scene_skip_levels,
    view_level_tables,
)

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CHECK_STEPS = 3  # steps of set-up that the reference follows
DTYPES = {None: None, "bfloat16": torch.bfloat16}


# ------------------------------------------------------------------ cells


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # the metric entries this cell reports, both kinds

    def metrics_of(self, kind):
        return [m for m in self.metrics if m["kind"] == kind]


def load_cell(workload, root=ROOT, bench_dir=BENCH_DIR):
    """The cell ``workload`` of ``<root>/BENCHMARK.json``: its configuration
    file (the entry's ``file``), ``<bench_dir>/traffic/<traffic>.json``,
    ``<bench_dir>/limits/<workload>.json`` and the metrics it reports."""
    root, bench_dir = Path(root), Path(bench_dir)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / config["file"]) as f:
        cfg = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench_dir / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in e2e_names)]
    metrics = ([dict(m, kind="end_to_end") for m in e2e]
               + [dict(m, kind="per_layer") for m in per_layer])
    return Cell(workload, w["chips"], cfg, traffic, limits, metrics)


def pipeline_config(cell):
    """The cell's ``PipelineConfig``: every value from its file."""
    p = dict(cell.config["pipeline"])
    p["compute_dtype"] = DTYPES[p["compute_dtype"]]
    for k, v in p.items():
        if isinstance(v, list):
            p[k] = tuple(v)
    return PipelineConfig(**p)


def run_config(cell, data_root, scene, style_path):
    """The cell's ``RunConfig``: its file's values, the traffic's batch
    and repeat, and the written scene's paths."""
    r = dict(cell.config["run"])
    r.update(views_per_batch=cell.traffic["views_per_step"],
             index_repeat=cell.traffic["index_repeat"],
             root_path=data_root, scene=scene, style_image_path=style_path)
    return RunConfig(**r)


def resolved(pipe_cfg):
    """A ``PipelineConfig`` as the plain dict the reference and the work
    model take."""
    d = dataclasses.asdict(pipe_cfg)
    d["compute_dtype"] = None if d["compute_dtype"] is None else str(
        d["compute_dtype"])
    return d


# ------------------------------------------------------------------ inputs


def make_vgg(seed, device):
    """VGG-19's convolutions (through conv5_4), drawn on ``device`` from
    ``seed`` in one call, in the types the bf16 trunk serves them in:
    He-normal OIHW weights in bf16, biases of deviation 0.05 in float32."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    sizes = [(cout * cin * 9, cout) for _, cin, cout in VGG_CONVS]
    flat = torch.randn(sum(a + b for a, b in sizes), generator=g,
                       device=device)
    params, at = {}, 0
    for (name, cin, cout), (nw, nb) in zip(VGG_CONVS, sizes):
        w = flat[at:at + nw].view(cout, cin, 3, 3) * math.sqrt(2.0 / (9 * cin))
        b = flat[at + nw:at + nw + nb] * 0.05
        params[name] = {"weight": w.to(torch.bfloat16).contiguous(),
                        "bias": b.contiguous()}
        at += nw + nb
    return params


def chunk_stream(train_idx, run):
    """``run_training``'s chunks, epoch after epoch, without end."""
    epoch = 0
    while True:
        if run.sampler_mode == "repeat" and run.index_repeat > 1:
            chunks = batched_repeat(train_idx, run.views_per_batch,
                                    run.index_repeat)
        else:
            chunks = batched(epoch_indices(train_idx, run.sampler_mode,
                                           run.index_repeat,
                                           seed=run.seed + epoch),
                             run.views_per_batch)
        yield from chunks
        epoch += 1


# ------------------------------------------------------------------ spans


class Spans:
    """The benchmark's host spans around the loop's calls. Off, a span is a
    shared null context; ``"mark"`` records its (start, end, name) on
    ``time.time_ns``, the profiler's clock; ``"sync"`` times it between
    two synchronizes."""

    _OFF = contextlib.nullcontext()

    def __init__(self, device):
        self.device = device
        self.mode = None
        self.marks = []
        self.times = {}

    def __call__(self, name):
        if self.mode is None:
            return self._OFF
        if self.mode == "mark":
            return self._marked(name)
        return self._timed(name)

    @contextlib.contextmanager
    def _marked(self, name):
        t0 = time.time_ns()
        yield
        self.marks.append((t0, time.time_ns(), name))

    @contextlib.contextmanager
    def _timed(self, name):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class ChunkLoop:
    """The run loop over chunks: a new chunk is fetched, moved and prepared
    once; each step's losses are read when the next step has been
    queued."""

    def __init__(self, pipe, state, cache, chunks, device):
        self.pipe, self.state, self.cache = pipe, state, cache
        self.chunks = chunks
        self.device = device
        self.spans = Spans(device)
        self.key = None
        self.batch = self.aux = None
        self.pending = None
        self.next_chunk = next(chunks)
        self.steps = 0
        self.failed = 0
        self.segments = []  # [chunk key, steps, prepared here]
        self.per_second = []

    @property
    def at_new_chunk(self):
        """Whether the next step starts a chunk."""
        return tuple(self.next_chunk) != self.key

    def step(self):
        """Queue one step; read the previous step's losses. Returns the
        queued step's losses (tensors)."""
        chunk, self.next_chunk = self.next_chunk, next(self.chunks)
        key = tuple(chunk)
        if key != self.key:
            with self.spans("get_batch"):
                host = self.cache.get_batch(chunk)
            with self.spans("to_device"):
                self.batch = batch_from_numpy(host, self.device)
            with self.spans("prepare_batch"):
                self.aux = self.pipe.prepare_batch(self.batch)
            self.key = key
            self.segments.append([key, 0, True])
        elif not self.segments or self.segments[-1][0] != key:
            self.segments.append([key, 0, False])
        with self.spans("train_step"):
            losses = self.pipe.train_step(self.state, self.batch, self.aux)
        self.segments[-1][1] += 1
        self.steps += 1
        with self.spans("read_losses"):
            self._read()
        self.pending = losses
        return losses

    def drain(self):
        """Read the last queued step's losses (waits for it)."""
        with self.spans("read_losses"):
            self._read()
        self.pending = None

    def _read(self):
        if self.pending is not None:
            values = [float(v) for v in self.pending.values()]
            if not all(math.isfinite(v) for v in values):
                self.failed += 1

    def cut(self):
        """The segments since the last cut: a stretch's chunks, each as
        [key, steps, prepared in the stretch]."""
        segs, self.segments = self.segments, []
        return segs


# ------------------------------------------------------------------ session


class Session:
    """A cell set up for one seed: the scene, the program under test, its
    loop, and the numbers of its first steps."""

    def __init__(self, cell, seed, device, workdir):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.phases = {}
        clock = time.perf_counter()

        def phase(name):
            nonlocal clock
            now = time.perf_counter()
            self.phases[name] = now - clock
            clock = now

        if self.device.type == "cuda":
            kernels.library()
        phase("kernel_library")
        self.data_root, scene, self.style_path = write_scene(
            workdir, cell.traffic["scene"], seed)
        phase("scene_write")
        self.run = run_config(cell, self.data_root, scene, self.style_path)
        pipe_cfg = pipeline_config(cell)
        spec = discover_scene(self.run)
        self.scene_dir = os.path.dirname(os.path.dirname(spec.rgb[0]))
        self.cache = SceneCache(spec, resize_size=self.run.resize_size)
        self.levels = [float(h) for h in spec.levels]
        phase("scene_cache")
        self.vgg = make_vgg(seed, self.device)
        style = load_style_image(self.style_path)
        # run_training's static level skip and its steps per epoch
        tables = loss_live, grad_live = view_level_tables(self.cache, pipe_cfg)
        skip = tuple(sorted(set(scene_skip_levels(self.cache, pipe_cfg, tables))
                            | set(pipe_cfg.skip_levels)))
        dead = tuple(sorted((set(scene_grad_dead_levels(self.cache, pipe_cfg,
                                                        tables))
                             | set(pipe_cfg.stop_grad_levels)) - set(skip)))
        self.train_idx, _ = make_split(
            self.cache.num_views, split=(self.run.train_split,
                                         self.run.val_split),
            split_mode=self.run.split_mode, shuffle=self.run.shuffle,
            seed=self.run.seed)
        steps_per_epoch = max(1, len(epoch_indices(
            self.train_idx, self.run.sampler_mode, self.run.index_repeat))
            // self.run.views_per_batch)
        self.pipe_cfg = dataclasses.replace(
            pipe_cfg, skip_levels=skip, stop_grad_levels=dead,
            steps_per_epoch=steps_per_epoch)
        _same_signature(self.cache, self.train_idx, self.run, self.pipe_cfg,
                        loss_live, grad_live)
        self.pipe = TexturePipeline(self.pipe_cfg, self.vgg, style,
                                    device=self.device)
        self.state = self.pipe.init()
        self._sync()
        phase("pipeline")
        self.texture_shapes = [tuple(l.shape[:2])
                               for l in self.state.texture.layers]
        self.loop = ChunkLoop(self.pipe, self.state, self.cache,
                              chunk_stream(self.train_idx, self.run),
                              self.device)
        self.numbers = self._first_steps()
        phase("first_steps")
        self.work = {}

    def _first_steps(self):
        """The loop's first :data:`CHECK_STEPS` steps, with the numbers the
        reference checks: each step's loss terms, the first gradient's norm
        per layer (from Adam's first moment after one step), each layer's
        change over the steps, and the content targets that
        ``prepare_batch`` encoded for the last of their chunks
        (``content_chunk``), ``{(level, layer): [V, h, w, C]}`` on the
        host."""
        adam_b1 = self.cell.config["adam"]["b1"]
        before = [l.detach().cpu().clone() for l in self.state.texture.layers]
        losses = [self.loop.step()]
        self._sync()
        grad = [float(mu.norm()) / (1.0 - adam_b1) for mu in self.state.mu]
        for _ in range(CHECK_STEPS - 1):
            losses.append(self.loop.step())
        self.loop.drain()
        self._sync()
        change = [float((l.detach().cpu().double() - b.double()).norm())
                  for l, b in zip(self.state.texture.layers, before)]
        self.first_chunks = [list(key) for key, n, _ in self.loop.cut()
                             for _ in range(n)]
        self.content_chunk = list(self.loop.key)
        targets = self.loop.aux.loss_aux["content_targets"]
        return {"losses": [{k: float(v) for k, v in l.items()}
                           for l in losses],
                "grad_norms": grad, "change_norms": change,
                "content": {(i, k): t.float().cpu()
                            for i, d in enumerate(targets)
                            for k, t in d.items()}}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def chunk_work(self, key):
        """The work model of chunk ``key`` (cached)."""
        if key not in self.work:
            views = work.host_views(self.cache.get_batch(list(key)))
            self.work[key] = work.ChunkWork(views, resolved(self.pipe_cfg),
                                            self.texture_shapes)
        return self.work[key]

    def free(self):
        """Drop the program's pipeline, state and batches."""
        self.loop = self.pipe = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _same_signature(cache, train_idx, run, pipe_cfg, loss_live, grad_live):
    """Raise unless every chunk of an epoch keeps every level of the run:
    the loop here has no per-chunk level specialization, which
    ``run_training`` would use for such a chunk."""
    for chunk in batched(list(train_idx), run.views_per_batch):
        pos = [cache._pos_of[i] for i in chunk]
        for i in range(loss_live.shape[1]):
            if i in pipe_cfg.skip_levels:
                continue
            dead = grad_live is not None and not grad_live[pos, i].any()
            if not loss_live[pos, i].any() or (
                    dead and i not in pipe_cfg.stop_grad_levels):
                raise ValueError(f"chunk {chunk} drops level {i}: the "
                                 f"traffic needs a per-chunk specialization")


# ------------------------------------------------------------------ window


@dataclasses.dataclass
class Stretch:
    """Part of a window: its wall time, its steps and chunk segments."""

    seconds: float
    steps: int
    segments: list
    timeline: object = None
    spans: dict = None


def _run_until(loop, seconds, whole_chunks=False):
    """Steps until ``seconds`` have passed (then, with ``whole_chunks``,
    until a chunk ends), the last step read. Returns (seconds, steps);
    ``loop.per_second`` counts the steps queued in each second."""
    steps0 = loop.steps
    t0 = time.perf_counter()
    loop.per_second = []
    while True:
        loop.step()
        elapsed = time.perf_counter() - t0
        second = int(elapsed)
        while len(loop.per_second) <= second:
            loop.per_second.append(0)
        loop.per_second[second] += 1
        if elapsed >= seconds and (not whole_chunks or loop.at_new_chunk):
            break
    loop.drain()
    return time.perf_counter() - t0, loop.steps - steps0


def _to_chunk_start(loop):
    while not loop.at_new_chunk:
        loop.step()
    loop.drain()
    loop.cut()


def measure(session, seconds):
    """The timed window: the loop for ``seconds``, ending when the last
    queued step has finished."""
    loop = session.loop
    wall, steps = _run_until(loop, seconds)
    return Stretch(wall, steps, loop.cut())


def measure_traced(session, seconds, profiled_s=1.0):
    """The traced window, in three stretches: an unprofiled one (0.4 of
    ``seconds``; ``mfu``), a profiled one of whole chunks lasting at least
    ``profiled_s`` (the device trace, CUDA activity only), and one of whole
    chunks whose spans end in synchronizes (``chunk_ms``, ``prepare_ms``)
    for the rest."""
    from torch.profiler import ProfilerActivity, profile

    loop = session.loop
    t0 = time.perf_counter()
    plain = Stretch(*_run_until(loop, 0.4 * seconds), loop.cut())
    _to_chunk_start(loop)
    loop.spans.mode = "mark"
    cuda = session.device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        start = time.time_ns()
        wall, steps = _run_until(loop, profiled_s, whole_chunks=True)
        session._sync()
        end = time.time_ns()
    timeline = devtrace.Timeline(devtrace.device_events(prof), start, end,
                                 loop.spans.marks)
    profiled = Stretch(wall, steps, loop.cut(), timeline=timeline)
    loop.spans.mode = "sync"
    rest = max(seconds - (time.perf_counter() - t0), 0.0)
    wall, steps = _run_until(loop, rest, whole_chunks=True)
    synced = Stretch(wall, steps, loop.cut(), spans=loop.spans.times)
    loop.spans.mode = None
    return {"plain": plain, "profiled": profiled, "synced": synced}


def warm_profiler(device):
    """Start the profiler once in set-up, so its first start is not paid in
    the profiled stretch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Record:
    """What a run's metric readers read."""

    session: Session
    setup_s: float
    window: Stretch = None
    stretches: dict = None
    peaks: dict = None
    window_peak_bytes: int = None

    @property
    def views_per_step(self):
        return self.session.run.views_per_batch


def load_peaks(device_name, bench_dir=BENCH_DIR):
    """The data-sheet peaks of the device named ``device_name``, or None."""
    with open(Path(bench_dir) / "peaks.json") as f:
        table = json.load(f)
    for entry in table["devices"]:
        if entry["match"] in device_name:
            return entry
    return None


@contextlib.contextmanager
def workdir():
    """A scratch directory under ``$TMPDIR``, removed at the end."""
    path = tempfile.mkdtemp(prefix="stylemesh_bench_")
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)

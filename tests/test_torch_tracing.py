"""The port's span and counter recorder (``utils/profiling.py``), the spans
and counters at its layer boundaries, and their join to a device trace by
launch (``benchmark/progtrace.py``), on the CPU.

- Off, a span is one shared null context and nothing is recorded.
- On, spans nest with their parents and the train step's count, in
  ``time.time_ns`` order; ``StepProfiler``'s phases are not spans.
- A CPU ``TexturePipeline`` step records ``train_step`` with ``forward``,
  ``backward`` and ``update``; ``run_training`` records the chunk path
  (``get_batch``, ``to_device``, ``prepare_batch``) and keeps the keys of
  ``wallclock.json``; ``to_device`` counts the bytes it copies from the
  host to another device, and nothing for a move within the host.
- The join of made-up spans, launch records and device operations: device
  time, launches and self time by span, a launch from another thread
  inside ``backward``, launches outside every span and with no record, and
  the idle gaps under the innermost span of the harness's and the
  program's.
"""

import contextlib
import json
import time

import numpy as np
import pytest
import torch

from benchmark import progtrace
from benchmark.scene import write_scene
from stylemesh_tpu_torch.convert import batch_from_numpy
from stylemesh_tpu_torch.data.schema import to_device
from stylemesh_tpu_torch.data.synthetic import synthetic_view_batch
from stylemesh_tpu_torch.models.pipeline import PipelineConfig, TexturePipeline
from stylemesh_tpu_torch.models.vgg import init_vgg_params
from stylemesh_tpu_torch.optimize import RunConfig, run_training
from stylemesh_tpu_torch.utils import profiling

TINY = dict(texture_width=32, texture_height=32, hierarchical_layers=1,
            kernel_compute="f32", precision="highest", remat_vgg=False)


def test_off_span_is_the_shared_null_context():
    a, b = profiling.span("a"), profiling.span("b", step=3)
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a:
        profiling.count("h2d_bytes", 7)
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    # a region's recorder is gone once it ends
    assert profiling.span("c") is a


def test_spans_nest_with_parents_steps_and_clock_order():
    t0 = time.time_ns()
    with profiling.recording() as rec:
        with profiling.span("outer", step=5):
            with profiling.span("a"):
                profiling.count("n", 2)
            with profiling.span("b"):
                with profiling.span("c", step=9):
                    profiling.count("n", 3)
        with profiling.span("top"):
            pass
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    t1 = time.time_ns()
    names = [s.name for s in rec.spans]
    assert names == ["outer", "a", "b", "c", "top"]
    assert [s.parent for s in rec.spans] == [None, 0, 0, 2, None]
    assert [s.step for s in rec.spans] == [5, 5, 5, 9, None]
    assert rec.counters == {"n": 5}
    outer, a, b, c, top = rec.spans
    assert t0 <= outer.start_ns <= a.start_ns <= a.end_ns <= b.start_ns
    assert b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= outer.end_ns
    assert outer.end_ns <= top.start_ns <= top.end_ns <= t1


def test_step_profiler_phase_keeps_its_totals_and_records_no_span():
    clock = profiling.StepProfiler()
    with profiling.recording() as rec:
        with clock.phase("scene_cache"):
            with profiling.span("inner"):
                pass
    assert [(s.name, s.parent) for s in rec.spans] == [("inner", None)]
    assert set(clock.summary()) == {"scene_cache"}
    assert clock.counts["scene_cache"] == 1


def _arrays(batch):
    return [x for f in batch if f is not None
            for x in (f if isinstance(f, tuple) else (f,))]


def test_to_device_counts_host_to_device_bytes_alone():
    host = synthetic_view_batch(num_views=2, content_hw=(24, 32),
                                level_heights=(16, 12), seed=3,
                                numpy_arrays=True)
    nbytes = sum(np.asarray(x).nbytes for x in _arrays(host))
    # ``meta`` stands for a device: the arrays cross from the host to it
    with profiling.recording() as rec:
        on_device = batch_from_numpy(host, "meta")
    assert rec.counters == {"h2d_bytes": nbytes}
    assert all(x.device.type == "meta" for x in _arrays(on_device))
    # a move within the host, or of what is on the device already, is no
    # copy to a device
    with profiling.recording() as rec:
        batch_from_numpy(host, "cpu")
        to_device(on_device, "meta")
    assert rec.counters == {}
    assert [s.name for s in rec.spans] == ["to_device", "to_device"]


def test_pipeline_step_records_forward_backward_update():
    host = synthetic_view_batch(num_views=2, content_hw=(24, 32),
                                level_heights=(16,), seed=2,
                                numpy_arrays=True)
    cfg = PipelineConfig(steps_per_epoch=1, **TINY)
    pipe = TexturePipeline(cfg, init_vgg_params(device="cpu"),
                           torch.zeros((1, 16, 16, 3)), device="cpu")
    state = pipe.init()
    state.step = 4
    with profiling.recording() as rec:
        batch = batch_from_numpy(host, "cpu")
        aux = pipe.prepare_batch(batch)
        pipe.train_step(state, batch, aux)
    assert rec.counters == {}  # the CPU is the host: nothing crossed
    spans = rec.spans
    assert [s.name for s in spans] == ["to_device", "prepare_batch",
                                       "train_step", "forward", "backward",
                                       "update"]
    step = spans[2]
    assert step.step == 4 and state.step == 5
    children = spans[3:]
    assert all(s.parent == 2 and s.step == 4 for s in children)
    bounds = [step.start_ns] + [t for s in children
                                for t in (s.start_ns, s.end_ns)]
    assert bounds == sorted(bounds) and children[-1].end_ns <= step.end_ns


def test_run_training_records_the_chunk_path(tmp_path):
    spec = dict(name="scene0000_00", views=4, photo_hw=[24, 32],
                uv_heights=[16, 24], uv_window=0.25, depth_range=[0.4, 7.0],
                valid_fraction=0.85, style_hw=[40, 52])
    root, scene, style = write_scene(str(tmp_path / "data"), spec, 3)
    run = RunConfig(root_path=root, scene=scene, style_image_path=style,
                    resize_size=24, min_pyramid_height=16, views_per_batch=2,
                    index_repeat=2, max_epochs=1, log_dir=str(tmp_path / "r"),
                    run_post_steps=False, save_texture=False)
    with profiling.recording() as rec:
        _, log_dir, _, _ = run_training(run, PipelineConfig(**TINY),
                                        device="cpu")
    names = [s.name for s in rec.spans]
    # two chunks of two steps each, then the validation batch
    assert names.count("train_step") == 4
    for n in ("forward", "backward", "update"):
        assert names.count(n) == 4
    assert names.count("get_batch") == names.count("to_device") == 3
    assert names.count("prepare_batch") == 3
    steps = [s.step for s in rec.spans if s.name == "train_step"]
    assert steps == [0, 1, 2, 3]
    assert {s.name for s in rec.spans if s.parent is None} == {
        "get_batch", "to_device", "prepare_batch", "train_step"}
    with open(f"{log_dir}/wallclock.json") as f:
        wall = json.load(f)
    assert {"scene_cache", "pipeline_build", "compile_first_step",
            "validation", "train_steps"} <= set(wall)


class _Event:
    """A made-up Kineto event: what ``progtrace.launch_trace`` reads
    (``thread``, which it does not read, is the launching thread)."""

    def __init__(self, kind, start, end, name, corr, thread=1):
        self.kind, self.start, self.end = kind, start, end
        self._name, self.corr, self.thread = name, corr, thread

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self.kind.startswith("cuda_")
                else torch.autograd.DeviceType.CUDA)

    def is_user_annotation(self):
        return self.kind == "gpu_user_annotation"

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def name(self):
        return self._name

    def correlation_id(self):
        return self.corr


class _KindedEvent(_Event):
    """A made-up event of a PyTorch whose events name their kind."""

    def activity_type(self):
        return self.kind


class _Profile:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _span(name, start, end, parent=None, step=None):
    return profiling.Span(name, start, end, parent, step)


def _made_up_events(ev=_KindedEvent):
    """Launch records and device operations (ns) of one step in [100,
    1000], with a copy to the card before it and a loss read after."""
    return [
        ev("cuda_runtime", 20, 30, "cudaMemcpyAsync", 1),
        ev("gpu_memcpy", 25, 75, "Memcpy HtoD (Pageable -> Device)", 1),
        ev("cuda_runtime", 150, 160, "cudaLaunchKernel", 2),
        ev("kernel", 200, 300, "conv3x3_gemm_kernel", 2),
        ev("cuda_runtime", 170, 175, "cudaLaunchKernel", 3),
        ev("kernel", 300, 340, "gather_kernel", 3),
        # the backward's launch comes from autograd's own thread
        ev("cuda_driver", 500, 510, "cuLaunchKernel", 4, thread=2),
        ev("kernel", 520, 700, "splat_kernel", 4),
        ev("cuda_runtime", 850, 860, "cudaLaunchKernel", 5),
        ev("kernel", 870, 950, "adam", 5),
        # the loss read, outside every program span
        ev("cuda_runtime", 1020, 1030, "cudaMemcpyAsync", 6),
        ev("gpu_memcpy", 1040, 1050, "Memcpy DtoH (Device -> Pageable)", 6),
        # a device operation whose launch was not recorded
        ev("kernel", 960, 980, "stray_kernel", 99),
        ev("gpu_user_annotation", 200, 900, "train_step", 0),
        # a runtime call that launches nothing
        ev("cuda_runtime", 600, 605, "cudaStreamIsCapturing", 7),
        # a launch whose device operation the profile lost
        ev("cuda_runtime", 610, 615, "cudaLaunchKernel", 8),
        # launched before the end, put after it by the device's clock
        ev("cuda_runtime", 1092, 1095, "cudaMemcpyAsync", 9),
        ev("gpu_memcpy", 1105, 1110, "Memcpy DtoH (Device -> Pageable)", 9),
        # launched and run before the start
        ev("cuda_runtime", -30, -25, "cudaLaunchKernel", 10),
        ev("kernel", -20, -10, "warm_kernel", 10),
    ]


def _made_up():
    """The join of :func:`_made_up_events` to a step's spans and the
    harness's marks."""
    spans = [_span("to_device", 10, 90),
             _span("train_step", 100, 1000, step=7),
             _span("forward", 110, 400, 1, 7),
             _span("backward", 400, 800, 1, 7),
             _span("update", 800, 990, 1, 7)]
    marks = [(5, 95, "to_device"), (98, 1002, "train_step"),
             (1010, 1090, "read_losses")]
    ops, launches, expected = progtrace.launch_trace(
        _Profile(_made_up_events()))
    return progtrace.Join(ops, launches, spans, marks, 0, 1100, steps=1,
                          counters={"h2d_bytes": 5000}, expected=expected)


@pytest.mark.parametrize("event", [_KindedEvent, _Event])
def test_launch_trace_links_device_operations_to_launches(event):
    ops, launches, expected = progtrace.launch_trace(
        _Profile(_made_up_events(event)))
    # the user annotation is not a device operation
    assert [c for _, _, _, c in ops] == [1, 2, 3, 4, 5, 6, 99, 9, 10]
    assert launches == {1: 20, 2: 150, 3: 170, 4: 500, 5: 850, 6: 1020,
                        7: 600, 8: 610, 9: 1092, 10: -30}
    assert expected == {1, 2, 3, 4, 5, 6, 8, 9, 10}


def test_join_gives_device_time_launches_and_self_time_by_span():
    join = _made_up()
    ms = 1e-9
    assert join.device_s("forward") == pytest.approx(140 * ms)
    assert join.launches("forward") == 2
    # launched from another thread while the step's thread waits
    assert join.device_s("backward") == pytest.approx(180 * ms)
    assert join.launches("backward") == 1
    assert join.device_s("update") == pytest.approx(80 * ms)
    # a parent holds its children's device time
    assert join.device_s("train_step") == pytest.approx(400 * ms)
    assert join.launches("train_step") == 4
    assert join.device_s("to_device", progtrace.H2D) == pytest.approx(50 * ms)
    assert join.device_s("to_device", ("DtoH",)) == 0
    # the two loss reads; the operation before the start is not the
    # stretch's, the one the device's clock puts after its end is
    assert join.device_s(progtrace.OUTSIDE) == pytest.approx(15 * ms)
    assert join.launches(progtrace.OUTSIDE) == 2
    assert join.device_s(progtrace.UNLINKED) == pytest.approx(20 * ms)
    assert join.missing == {8}
    assert join.host_s("train_step") == [pytest.approx(900 * ms)]
    assert join.self_s("train_step") == pytest.approx((900 - 290 - 400 - 190)
                                                      * ms)
    assert join.self_s("forward") == pytest.approx(290 * ms)
    rows = {r[0]: r[1:] for r in join.rows()}
    assert list(rows) == ["to_device", "train_step", "forward", "backward",
                          "update", progtrace.OUTSIDE, progtrace.UNLINKED]
    assert rows["train_step"] == pytest.approx([900e-6, 20e-6, 400e-6, 4])
    assert rows[progtrace.OUTSIDE] == pytest.approx([0, 0, 15e-6, 2])


def test_join_idle_gaps_under_the_innermost_span():
    join = _made_up()
    ns = 1e-9
    # busy [25, 75], [200, 340], [520, 700], [870, 950], [960, 980],
    # [1040, 1050], [1105, 1110] (the stretch now ends there); each gap
    # goes to the innermost span open at its start
    assert dict(join.idle_gaps()) == pytest.approx({
        progtrace.OUTSIDE: 25 * ns,  # [0, 25]
        "to_device": 125 * ns,  # [75, 200], the program's span
        "forward": 180 * ns,  # [340, 520]
        "backward": 170 * ns,  # [700, 870]
        "update": 70 * ns,  # [950, 960], [980, 1040]
        "read_losses": 55 * ns,  # [1050, 1105], the harness's span
    })
    assert join.timeline.busy_s == pytest.approx(485 * ns)
    assert join.timeline.window_s == pytest.approx(1110 * ns)

"""The train step's CUDA graphs (``models/step_graph.py``) and what they
rest on.

On the CPU, where the step is always eager:

- Adam reading its rate and bias corrections from a device tensor equals
  the formula with Python scalars bit for bit, over 70 steps across a
  StepLR decay (the same roundings on the CPU);
- a CPU pipeline's step is eager: no graph counter, the spans of
  ``eager_step``;
- ``AtlasShardedPipeline`` never takes the graph path, even with one set;
- the update keeps the state's tensors, the Gram cache's too;
- the helpers: a batch and its constants rebuilt from their tensors, the
  signature's view of shapes and shared tensors, every kernel wrapper's
  launch counter found.

On a card (marked ``cuda``; without JAX, from the repo root:
``python -m pytest --noconftest -m cuda tests/test_torch_step_graph.py``):

- graphed steps against eager ones, 2 chunks of 5 steps, for the full
  method and a ``*_dip`` (``gram_mode="average"``) configuration, in
  lockstep: before each step the eager state is set to the graphed one.
  Texture, Adam moments, Gram cache and every step's loss terms within
  1e-6 relative (the same kernels, launched another way; K2's float32
  atomics add in another order from run to run, about 1e-7 of a step's
  state). Free-running, two eager runs of the full method already part by
  5e-3 of the state after 10 steps: Adam's sign-like early steps amplify
  that noise. The loss dicts are read after every step was queued, so
  each must hold its own step's values. ``tex_reg_folded`` counts every
  update of the full method (the regularizer on), none of ``dip``'s;
- one capture over three chunks, and one K1 and one K2 launch counted a
  step; one launch of the one-pass update a step, eager or replayed, and
  one of the regularizer's value (with it on);
- a state whose tensors are replaced is captured again.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stylemesh_tpu_torch.convert import batch_from_numpy
from stylemesh_tpu_torch.data.synthetic import synthetic_view_batch
from stylemesh_tpu_torch.models import step_graph
from stylemesh_tpu_torch.models.losses import StyleTargets
from stylemesh_tpu_torch.models.pipeline import (
    ADAM_B1,
    ADAM_B2,
    ADAM_EPS,
    PipelineConfig,
    TexturePipeline,
)
from stylemesh_tpu_torch.models.texture import Texture
from stylemesh_tpu_torch.models.vgg import init_vgg_params
from stylemesh_tpu_torch.ops import (
    adam_kernels,
    conv_im2col,
    conv_kernels,
    gram_kernels,
    grid_sample,
    head_kernels,
)
from stylemesh_tpu_torch.ops.color import GATYS_MAX, GATYS_MIN
from stylemesh_tpu_torch.parallel.atlas import AtlasShardedPipeline
from stylemesh_tpu_torch.parallel.mesh import Mesh
from stylemesh_tpu_torch.utils import profiling

TINY = dict(texture_width=32, texture_height=32, hierarchical_layers=1,
            kernel_compute="f32", precision="highest", remat_vgg=False)
STEP_SPANS = ["train_step", "forward", "backward", "update"]


def _tiny_pipe(**overrides):
    cfg = PipelineConfig(steps_per_epoch=1, **{**TINY, **overrides})
    return TexturePipeline(cfg, init_vgg_params(device="cpu"),
                           torch.zeros((1, 16, 16, 3)), device="cpu")


def _tiny_batch(seed=2, levels=(16,)):
    host = synthetic_view_batch(num_views=2, content_hw=(24, 32),
                                level_heights=levels, seed=seed,
                                numpy_arrays=True)
    return batch_from_numpy(host, "cpu")


# ---------------------------------------------------------------- CPU


def test_adam_on_device_scalars_matches_python_scalar_formula():
    decay = 40
    cfg = PipelineConfig(steps_per_epoch=1, texture_width=32,
                         texture_height=32, hierarchical_layers=2,
                         learning_rate=1.0, decay_gamma=0.1,
                         decay_step_size=decay)
    pipe = TexturePipeline(cfg, {}, None, device="cpu",
                           style_targets=StyleTargets(grams={}))
    state = pipe.init()
    layers = [l.detach().clone() for l in state.texture.layers]
    mus = [torch.zeros_like(l) for l in layers]
    nus = [torch.zeros_like(l) for l in layers]
    rng = np.random.default_rng(0)
    for step in range(70):
        grads = [torch.from_numpy(rng.normal(0.0, 1.0, tuple(l.shape))
                                  .astype(np.float32)) for l in layers]
        pipe.apply_update(state, grads)
        # the update as it was written with Python scalars
        lr = cfg.learning_rate * cfg.decay_gamma ** (step // decay)
        bc1, bc2 = 1.0 - ADAM_B1 ** (step + 1), 1.0 - ADAM_B2 ** (step + 1)
        for p, g, mu, nu in zip(layers, grads, mus, nus):
            mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            denom = (nu / bc2).sqrt_().add_(ADAM_EPS)
            p.addcdiv_(mu / bc1, denom, value=-lr).clamp_(GATYS_MIN,
                                                          GATYS_MAX)
    assert state.step == 70
    for got, want in ((state.texture.layers, layers), (state.mu, mus),
                      (state.nu, nus)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.detach().numpy(), w.numpy())


def test_cpu_step_stays_eager():
    pipe = _tiny_pipe()
    state = pipe.init()
    batch = _tiny_batch()
    aux = pipe.prepare_batch(batch)
    with profiling.recording() as rec:
        for _ in range(3):
            pipe.train_step(state, batch, aux)
    assert pipe._graphs is None
    # no capture, no replay, and no launch to count on the CPU
    assert rec.counters == {}
    assert [s.name for s in rec.spans] == STEP_SPANS * 3
    assert state.step == 3


class _NoGraphs:
    def step(self, *args):
        raise AssertionError("the step took the graph path")


def test_atlas_step_never_takes_the_graph_path():
    pipe = AtlasShardedPipeline(PipelineConfig(steps_per_epoch=1, **TINY),
                                init_vgg_params(device="cpu"),
                                torch.zeros((1, 16, 16, 3)), Mesh())
    pipe._graphs = _NoGraphs()
    state = pipe.init()
    batch = _tiny_batch()
    aux = pipe.prepare_batch(batch)
    with profiling.recording() as rec:
        for _ in range(2):
            pipe.train_step(state, batch, aux)
    assert rec.counters == {}
    assert [s.name for s in rec.spans] == STEP_SPANS * 2
    assert state.step == 2


def test_update_keeps_the_state_tensors():
    pipe = _tiny_pipe(gram_mode="average", style_pyramid_mode="single",
                      use_angle_weight=False, use_depth_scaling=False,
                      content_weight=7e1, style_weight=1e-3)
    state = pipe.init()
    before = step_graph._state_tensors(state)
    batch = _tiny_batch()
    aux = pipe.prepare_batch(batch)
    for _ in range(2):
        pipe.train_step(state, batch, aux)
    after = step_graph._state_tensors(state)
    assert len(after) == len(before) == 3 + 5 + 1  # layer, mu, nu; cache
    assert all(a is b for a, b in zip(after, before))
    assert int(state.gram_cache.count) == 4  # 2 views x 1 level x 2 steps
    assert float(state.gram_cache.grams["r11"][0].abs().sum()) > 0
    assert state.gram_cache.push_log is None


def test_batch_and_constants_rebuild_from_their_tensors():
    pipe = _tiny_pipe(use_angle_weight=True, use_depth_scaling=True,
                      style_pyramid_mode="multi")
    batch = _tiny_batch(levels=(16, 24))
    aux = pipe.prepare_batch(batch)
    tree = (batch, aux)
    tensors = list(step_graph._tensors(tree))
    copies = [t.clone() for t in tensors]
    rebuilt = step_graph._rebuilt(tree, iter(copies))
    assert type(rebuilt[0]) is type(batch) and type(rebuilt[1]) is type(aux)
    assert step_graph._structure(rebuilt) == step_graph._structure(tree)
    assert all(a is b for a, b in
               zip(step_graph._tensors(rebuilt), copies))
    # tensors the constants share (r41 and r42 share a resolution) show
    firsts = step_graph._firsts(tensors)
    assert any(f != i for i, f in enumerate(firsts))
    assert all(tensors[f] is t for t, f in zip(tensors, firsts))
    # another chunk of the same shapes has the same signature; another
    # view count not
    other = _tiny_batch(seed=5, levels=(16, 24))
    other_tree = (other, pipe.prepare_batch(other))
    assert step_graph._structure(other_tree) == step_graph._structure(tree)
    assert step_graph._firsts(list(step_graph._tensors(other_tree))) == firsts
    three = batch_from_numpy(synthetic_view_batch(
        num_views=3, content_hw=(24, 32), level_heights=(16, 24), seed=2,
        numpy_arrays=True), "cpu")
    assert (step_graph._structure((three, pipe.prepare_batch(three)))
            != step_graph._structure(tree))


def test_every_kernel_wrapper_launch_counter_is_found():
    found = {(fn, attr) for fn, attr in step_graph._launch_counters()}
    want = {(grid_sample.gather_levels, "launches"),
            (grid_sample.gather_levels, "bf16_launches"),
            (grid_sample.splat_levels, "launches"),
            (grid_sample.splat_levels, "bf16_launches"),
            (grid_sample.gather_levels, "banded_launches"),
            (grid_sample.gather_levels, "banded_bf16_launches"),
            (grid_sample.splat_levels, "banded_launches"),
            (grid_sample.splat_levels, "banded_bf16_launches"),
            (grid_sample.gather_each, "launches"),
            (gram_kernels.masked_gram_sums, "launches"),
            (gram_kernels.masked_gram_sums_grad, "launches"),
            (conv_kernels.conv3x3, "launches"),
            (conv_kernels.conv3x3_mxu, "launches"),
            (head_kernels.conv_relu_pool, "launches"),
            (head_kernels.conv_relu_pool, "dual_launches"),
            (head_kernels.conv_relu_pool_bwd, "launches"),
            (head_kernels.pool_route, "launches"),
            (conv_im2col.stem_forward, "launches"),
            (conv_im2col.stem_backward, "launches"),
            (adam_kernels.adam_clamp_, "launches"),
            (adam_kernels.tex_reg_value, "launches")}
    assert want <= found
    # every counter of launch_counts() is among them
    assert len([1 for fn, attr in found if fn in (
        grid_sample.gather_levels, grid_sample.splat_levels,
        grid_sample.gather_each)]) == len(grid_sample.launch_counts())


# ---------------------------------------------------------------- card

FULL = dict(steps_per_epoch=1, texture_width=512, texture_height=512,
            hierarchical_layers=4, use_angle_weight=True,
            use_depth_scaling=True, content_weight=7e1, style_weight=1e-4,
            tex_reg_weight=5e3, style_pyramid_mode="multi",
            angle_threshold=30.0, learning_rate=1.0, decay_step_size=3,
            style_min_size=32, remat_vgg=True, remat_min_px=5000,
            compute_dtype=torch.bfloat16, precision="default",
            kernel_compute="bf16")
DIP = dict(FULL, hierarchical_layers=1, style_weight=1e-3, tex_reg_weight=0.0,
           style_weights=(1000.0, 1000.0, 10.0, 10.0, 1000.0),
           style_pyramid_mode="single", gram_mode="average",
           angle_threshold=3000.0, use_angle_weight=False,
           use_depth_scaling=False, decay_step_size=15)
LEVELS = {"full": (64, 96), "dip": (64,)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels are built for sm_90a")
    return torch.device("cuda")


def _card_pipe(name, device):
    rng = np.random.default_rng(0)
    style = torch.from_numpy(
        (rng.random((1, 64, 85, 3), dtype=np.float32) - 0.45) * 255.0)
    cfg = PipelineConfig(**(FULL if name == "full" else DIP))
    return TexturePipeline(cfg, init_vgg_params(rng=0, he=True,
                                                device=device),
                           style, device=device)


def _card_chunks(name, device, n):
    return [synthetic_view_batch(num_views=2, content_hw=(64, 85),
                                 level_heights=LEVELS[name], seed=seed,
                                 depth_range=(0.4, 1.2), device=device)
            for seed in range(n)]


def _lockstep(name, device):
    """Graphed steps of one pipeline and eager steps of another over 2
    chunks of 5 steps, the eager state set to the graphed one before each
    step: both steps' loss terms (the dicts read after every step was
    queued) and both states after each step."""
    graphed, eager = _card_pipe(name, device), _card_pipe(name, device)
    g_state, e_state = graphed.init(), eager.init()
    g_losses, e_losses, states = [], [], []
    for batch in _card_chunks(name, device, 2):
        g_aux, e_aux = graphed.prepare_batch(batch), eager.prepare_batch(batch)
        for _ in range(5):
            with torch.no_grad():
                for e, g in zip(step_graph._state_tensors(e_state),
                                step_graph._state_tensors(g_state)):
                    e.copy_(g)
            e_state.step = g_state.step
            g_losses.append(graphed.train_step(g_state, batch, g_aux))
            e_losses.append(eager.eager_step(e_state, batch, e_aux))
            states.append([(g.detach().clone(), e.detach().clone()) for g, e in
                           zip(step_graph._state_tensors(g_state),
                               step_graph._state_tensors(e_state))])
    torch.cuda.synchronize()
    read = [[{k: float(v) for k, v in l.items()} for l in h]
            for h in (g_losses, e_losses)]
    return read[0], read[1], states, g_state.step


def _graph_counts(rec):
    """The recording's step counters (its ``h2d_bytes`` counts the
    synthetic batches' copies)."""
    return {k: n for k, n in rec.counters.items() if k != "h2d_bytes"}


def _rel(got, want):
    return float((got.double() - want.double()).norm()
                 / max(float(want.double().norm()), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["full", "dip"])
def test_graphed_steps_match_eager_steps(card, name):
    with profiling.recording() as rec:
        g_losses, e_losses, states, steps = _lockstep(name, card)
    # the graphed pipeline: one eager step, one capture; the other's 10
    folded = {"tex_reg_folded": 20} if name == "full" else {}
    assert _graph_counts(rec) == {"eager_steps": 11, "step_graph_captures": 1,
                                  "step_graph_replays": 9, **folded}
    assert steps == 10
    for got, want in zip(g_losses, e_losses):
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-6 * abs(w), (k, got, want)
    # each dict holds its own step's losses
    assert len({l["total"] for l in g_losses}) == len(g_losses)
    # 4 layers, mu, nu; 1 layer, mu, nu, 5 cached Grams and the count
    assert {len(s) for s in states} == {12 if name == "full" else 9}
    for after in states:
        for got, want in after:
            if want.is_floating_point():
                assert _rel(got, want) <= 1e-6
            else:
                assert torch.equal(got, want)


@pytest.mark.cuda
def test_one_capture_over_three_chunks_and_launches_counted(card):
    pipe = _card_pipe("full", card)
    state = pipe.init()
    deltas = []
    with profiling.recording() as rec:
        for batch in _card_chunks("full", card, 3):
            aux = pipe.prepare_batch(batch)
            for _ in range(3):
                before = grid_sample.launch_counts()
                pipe.train_step(state, batch, aux)
                after = grid_sample.launch_counts()
                deltas.append({k: n - before[k] for k, n in after.items()
                               if n != before[k]})
    torch.cuda.synchronize()
    assert _graph_counts(rec) == {"eager_steps": 1, "step_graph_captures": 1,
                                  "step_graph_replays": 8, "tex_reg_folded": 9}
    assert deltas == [{"gather_bf16": 1, "splat_bf16": 1}] * 9


@pytest.mark.cuda
def test_update_launches_once_a_step(card):
    """The one-pass update launches once a step, eager or replayed, and so
    does the regularizer's value: the replays add what their capture
    launched."""
    pipe = _card_pipe("full", card)
    state = pipe.init()
    batch = _card_chunks("full", card, 1)[0]
    aux = pipe.prepare_batch(batch)
    deltas = []
    for _ in range(4):  # eager, capture and replay, two replays
        before = (adam_kernels.adam_clamp_.launches,
                  adam_kernels.tex_reg_value.launches)
        pipe.train_step(state, batch, aux)
        deltas.append((adam_kernels.adam_clamp_.launches - before[0],
                       adam_kernels.tex_reg_value.launches - before[1]))
    torch.cuda.synchronize()
    assert deltas == [(1, 1)] * 4
    assert state.step == 4


@pytest.mark.cuda
def test_replaced_state_tensors_are_captured_again(card):
    pipe = _card_pipe("full", card)
    state = pipe.init()
    batch = _card_chunks("full", card, 1)[0]
    aux = pipe.prepare_batch(batch)
    with profiling.recording() as rec:
        for _ in range(3):
            pipe.train_step(state, batch, aux)
        # a restored checkpoint: the same values in new tensors
        state = dataclasses.replace(
            state, texture=Texture([l.detach().clone()
                                    for l in state.texture.layers]),
            mu=[m.clone() for m in state.mu], nu=[n.clone() for n in state.nu])
        for _ in range(3):
            losses = pipe.train_step(state, batch, aux)
    torch.cuda.synchronize()
    assert _graph_counts(rec) == {"eager_steps": 2, "step_graph_captures": 2,
                                  "step_graph_replays": 4, "tex_reg_folded": 6}
    assert state.step == 6
    assert all(np.isfinite(float(v)) for v in losses.values())

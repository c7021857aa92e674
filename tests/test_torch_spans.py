"""The port's profiler spans (`utils/metrics.py:span`): free when no
profiler records, and opened at the render and gradient paths' layer
boundaries when one does.  CPU, tiny shapes; the launch spans need the
card (`span_cases.py`, run there by `chip_smoke.py`)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import haskell_path_tracer_torch as hpt
from haskell_path_tracer_torch.models import scenes
from haskell_path_tracer_torch.ops.rng import gen_seeds
from haskell_path_tracer_torch.render.renderer import Renderer
from haskell_path_tracer_torch.utils import metrics as M
from haskell_path_tracer_torch.utils.config import RenderConfig


def hpt_spans(prof) -> list:
    """[(name, start ns, end ns)] of the port's spans, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("hpt.")]
    return sorted(out, key=lambda s: s[1])


def named(spans, name) -> list:
    return [s for s in spans if s[0] == name]


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] <= inner[2] <= outer[2]


def parts(scene) -> int:
    return sum(1 for p in (scene.spheres, scene.planes, scene.boxes, scene.triangles) if p.count)


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a record function was made for {name!r}")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = M.span("hpt.a"), M.span("hpt.b")
    assert a is b
    with a, b:
        pass
    m = M.RenderMetrics()
    with m.phase("render"):
        pass
    assert "render" in m.phase_seconds


def test_spans_are_function_scoped_and_phases_open_them():
    """A span is not user-scoped: the profiler mirrors user-scoped spans
    onto the device's timeline, where they would read as device work."""
    m = M.RenderMetrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.phase("write"):
            with M.span("hpt.test"):
                torch.ones(4).sum()
    events = {e.name: e for e in prof.events() if e.name.startswith("hpt.")}
    assert set(events) == {"hpt.cli.write", "hpt.test"}
    user = torch._C._profiler.RecordScope.USER_SCOPE
    assert all(e.scope != int(user) for e in events.values())
    spans = hpt_spans(prof)
    assert inside(named(spans, "hpt.test")[0], named(spans, "hpt.cli.write")[0])
    assert m.phase_seconds["write"] > 0


def test_render_spans_per_frame_and_step():
    scene, camera = scenes.cornell_scene("cpu"), hpt.initial_camera("cpu")
    renderer = Renderer(RenderConfig(width=8, height=6, algorithm="physical", bounces=2,
                                     device="cpu"))
    renderer.render(scene, camera, 2, seed=5)  # reads the scene's kinds and emitters
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for seed in (1, 2):
            renderer.render(scene, camera, 3, seed=seed)
    spans = hpt_spans(prof)
    steps = named(spans, "hpt.render.step")
    assert len(named(spans, "hpt.rng.seed")) == 2 and len(steps) == 2 * 3
    rays = named(spans, "hpt.camera.rays")
    assert all(sum(inside(r, s) for r in rays) == 1 for s in steps)
    assert not any(inside(r, s) for r in named(spans, "hpt.rng.seed") for s in steps)
    assert not named(spans, "hpt.host_read")


def test_gradient_spans_and_host_reads():
    scene, camera = scenes.cornell_scene("cpu"), hpt.initial_camera("cpu")
    params, rng = hpt.scene_to_params(scene), gen_seeds((6, 8), 1, "cpu")
    target = torch.full((6, 8, 3), 0.2)
    kw = dict(num_bounces=2, spp=1, estimator="physical",
              light_idx=hpt.scene_light_indices(scene))
    for kinds, reads in ((None, parts(scene)), (frozenset({0, 1}), 0)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            hpt.loss_and_grad(params, scene, camera, target, rng, kinds=kinds, **kw)
        spans = hpt_spans(prof)
        (forward,), (backward,) = named(spans, "hpt.grad.forward"), named(spans, "hpt.grad.backward")
        assert forward[2] <= backward[1]
        host_reads = named(spans, "hpt.host_read")
        assert len(host_reads) == reads
        assert all(inside(r, forward) for r in host_reads)


def test_host_read_and_has_dielectric():
    scene = scenes.cornell_scene("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = M.host_read(torch.arange(3))
        glass = scene.has_dielectric()
    assert got.tolist() == [0, 1, 2] and not glass
    assert len(named(hpt_spans(prof), "hpt.host_read")) == 1 + parts(scene)


@pytest.mark.chip
def test_launch_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels' launch spans open only there "
                    "(chip_smoke.py runs span_cases.check_launch_spans on the card)")
    import span_cases

    span_cases.check_launch_spans("cuda:0")

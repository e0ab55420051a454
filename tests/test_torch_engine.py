"""The port's slice end to end on the CPU: the triangle golden through the
port's render graph, the sandbox app through zenith_tpu_torch.launch against
the reference app at fixed times, retained against rebuilt frames, and the
engine-level contracts (frame-function cache, dynamics, swapchain cadence,
explicit devices, the kernel build).

Tolerances: encoded frames ≤ 1 LSB with < 1% of pixels differing (the
reference's golden tolerance, tests/test_golden.py); port-against-port
frames exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from zenith_tpu_torch.app import RenderableApp
from zenith_tpu_torch.launch import launch
from zenith_tpu_torch.rendergraph import (
    CompileOptions,
    RenderGraphBuilder,
    clear_frame_program_cache,
    frame_program_cache_size,
)
from zenith_tpu_torch.rhi import (
    Buffer,
    ColorAttachmentDesc,
    CullMode,
    Format,
    GraphicShaderInput,
    PipelineCache,
    RasterizationState,
    RhiCore,
    Shader,
    Texture,
    TextureDesc,
    encode_present,
    uniform,
)
from zenith_tpu_torch.rhi.state import GraphicPipelineState
from zenith_tpu_torch.renderer import triangle as tri_mod
from zenith_tpu_torch.window import Window

torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H = 128, 32
OPTS = CompileOptions(tile_h=8, tile_w=128, bin_capacity=16)
GOLDEN = Path(__file__).parent / "golden" / "triangle_128x32_t1_25.npy"
TRI_VB = np.array(
    [[0.0, 0.5, 0.0, 1.0, 0.0, 0.0], [-0.5, -0.5, 0.0, 0.0, 1.0, 0.0],
     [0.5, -0.5, 0.0, 0.0, 0.0, 1.0]], np.float32,
)
TRI_IB = np.array([0, 1, 2], np.int32)
VS = Shader.vertex("tri.vs", tri_mod._vs)
FS = Shader.fragment("tri.ps", tri_mod._fs, bindings=[uniform("Time")])


def build_triangle_graph(vb, ib, output_tex, t):
    """tests/test_rendergraph.py::build_triangle_graph, on the port."""
    builder = RenderGraphBuilder()
    vbr = builder.import_resource(vb)
    ibr = builder.import_resource(ib)
    out = builder.import_resource(output_tex)
    builder.set_dynamic("time", t)
    node = builder.add_graphic_node("triangle")
    vba, iba, rt = node.read(vbr), node.read(ibr), node.write(out)
    state = GraphicPipelineState(rasterization=RasterizationState(cull_mode=CullMode.NONE))
    with node.pipeline(GraphicShaderInput(VS, FS, tri_mod.VERTEX_LAYOUT), state) as binder:
        binder.push_color(rt, ColorAttachmentDesc(clear_value=(0.1, 0.1, 0.1, 1.0)))

    def record(ctx):
        ctx.bind("Time", ctx.dynamic("time"))
        ctx.draw_indexed(vba, iba)

    node.execute(record)
    return builder.build(), out


def _assert_frames_close(a, b):
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1, f"max LSB diff {diff.max()}"
    assert (diff > 0).mean() < 0.01


def test_triangle_golden_through_the_port_graph():
    device = RhiCore(CPU).create_render_device()
    vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
    ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)
    tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
    graph, out = build_triangle_graph(vb, ib, tex, 1.25)
    compiled = graph.compile(device, PipelineCache(), OPTS)
    compiled.execute(device)
    img = encode_present(compiled.value(out), Format.RGBA8_SRGB).numpy()
    _assert_frames_close(img, np.load(GOLDEN))


def _fixed_time_app(base):
    """The sandbox TriangleApp with its clock replaced by frame index × 0.25
    (so both packages render the same times)."""

    class App(base):
        def __init__(self, args):
            super().__init__(args)
            self.frame = 0

        def tick(self, dt):
            self.frame += 1

        def render(self, context):
            builder = context.builder()
            out = builder.import_resource(context.swapchain_texture())
            w, h = context.extent
            self.triangle_renderer.render_to(builder, out, w, h,
                                             time_s=np.float32(self.frame * 0.25))

        def update_dynamics(self):
            return self.triangle_renderer.frame_dynamics(np.float32(self.frame * 0.25))

    return App


def _port_frames(app_cls, frames=3, **window_kw):
    clear_frame_program_cache()
    window = Window(width=W, height=H, title="t", **window_kw)
    loop = launch(app_cls, argv=[], window=window, max_frames=frames,
                  device=CPU)
    assert loop.frames_rendered == frames
    return loop, window


def test_sandbox_app_through_launch_matches_the_reference_app():
    from zenith_tpu.launch import launch as jlaunch
    from zenith_tpu.rendergraph.graph import clear_frame_program_cache as jclear
    from zenith_tpu.sandbox.triangle import TriangleApp as JTriangleApp
    from zenith_tpu.window import Window as JWindow
    from zenith_tpu_torch.sandbox.triangle import TriangleApp

    jclear()
    jwindow = JWindow(width=W, height=H, title="t")
    jlaunch(_fixed_time_app(JTriangleApp), argv=[], window=jwindow,
            max_frames=3)
    _, window = _port_frames(_fixed_time_app(TriangleApp))
    assert window.last_frame.shape == (H, W, 4) and window.last_frame.dtype == np.uint8
    _assert_frames_close(window.last_frame, np.asarray(jwindow.last_frame))
    assert window.last_frame[..., :3].std() > 1.0


def test_retained_frames_equal_rebuilt_frames():
    from zenith_tpu_torch.sandbox.triangle import TriangleApp

    retained_cls = _fixed_time_app(TriangleApp)

    class Rebuild(retained_cls):
        update_dynamics = None

    _, rebuilt = _port_frames(Rebuild, frames=4)
    assert frame_program_cache_size() == 1  # every rebuild hit one frame function
    _, retained = _port_frames(retained_cls, frames=4)
    np.testing.assert_array_equal(retained.last_frame, rebuilt.last_frame)


def test_triangle_app_auto_retains():
    from zenith_tpu_torch.sandbox.triangle import TriangleApp

    calls = []

    class App(TriangleApp):
        def render(self, context):
            calls.append(1)
            super().render(context)

    loop, window = _port_frames(App, frames=4)
    assert len(calls) == 1  # frames 2-4 re-ran the cached frame function
    assert loop.app.triangle_renderer.last_time_s is not None
    assert window.presented_frames == 4


def test_simple_app_clears_to_blue():
    from zenith_tpu_torch.sandbox.simple import SimpleApp

    _, window = _port_frames(SimpleApp, frames=2)
    # BGRA8_SRGB of linear (0.2, 0.3, 0.8): sRGB 124, 149, 231 in B, G, R order.
    np.testing.assert_array_equal(window.last_frame[0, 0], [231, 149, 124, 255])


@pytest.mark.parametrize("interval, delivered", [(0, 0), (2, 3), (1, 5)])
def test_swapchain_readback_interval(monkeypatch, interval, delivered):
    from zenith_tpu_torch.sandbox.triangle import TriangleApp

    monkeypatch.setenv("ZENITH_READBACK_INTERVAL", str(interval))
    _, window = _port_frames(TriangleApp, frames=5)
    assert window.presented_frames == delivered


def test_retained_execute_rejects_a_changed_dynamics_signature():
    device = RhiCore(CPU).create_render_device()
    vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
    ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)
    tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
    graph, out = build_triangle_graph(vb, ib, tex, 0.5)
    compiled = graph.compile(device, PipelineCache(), OPTS)
    compiled.execute(device, dynamics={"time": np.float32(0.75)})
    host = encode_present(compiled.value(out), Format.RGBA8_SRGB)
    # A tensor, or a Python float (float32, as set_dynamic makes it), of the
    # same shape is the same signature.
    for same in (torch.tensor(0.75), 0.75):
        compiled.execute(device, dynamics={"time": same})
        assert torch.equal(encode_present(compiled.value(out), Format.RGBA8_SRGB), host)
    with pytest.raises(ValueError, match="signature"):
        compiled.execute(device, dynamics={"time": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        compiled.execute(device, dynamics={"not_declared": np.float32(1)})


def test_cuda_is_requested_explicitly_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RhiCore("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch(RenderableApp, argv=[], window=Window(width=W, height=H), max_frames=1)
    assert RhiCore(CPU).create_render_device().device == CPU


def test_kernel_build_is_keyed_by_the_sources_and_needs_nvcc(monkeypatch, tmp_path):
    from zenith_tpu_torch.ops import runtime

    so = runtime.library_path()
    assert so.parent == runtime.BUILD_DIR and so == runtime.library_path()
    assert "arch=compute_90a,code=sm_90a" in runtime.NVCC_FLAGS
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        runtime.build_kernels()


def test_unported_graph_modes_raise():
    """A graph mode the port does not have raises ValueError naming the
    ones it has, with no mesh as with one; those (sort_first and the
    triangle-sharded sort_last and auto) compile without a mesh and render
    the single-device frame. ``serve=`` serves and stops: port 0 picks a
    free port, the loop renders its frames behind the viewer and the
    viewer's thread is gone afterwards."""
    import threading

    device = RhiCore(CPU).create_render_device()
    vb = Buffer.from_numpy("tri.vb", TRI_VB, device=CPU)
    ib = Buffer.from_numpy("tri.ib", TRI_IB, device=CPU)
    tex = Texture(TextureDesc.color("swap", W, H), device=CPU)
    graph, swap = build_triangle_graph(vb, ib, tex, 0.5)
    with pytest.raises(ValueError, match="expected one of"):
        graph.compile(device, PipelineCache(), CompileOptions(parallel="sort_middle"))
    frames = []
    for mode in ("sort_first", "sort_last", "auto"):
        compiled = graph.compile(device, PipelineCache(), CompileOptions(parallel=mode))
        compiled.execute(device)
        frames.append(compiled.value(swap))
        assert graph.parallel_modes == {}
    assert torch.equal(frames[0], frames[1]) and torch.equal(frames[0], frames[2])
    from zenith_tpu_torch.sandbox.simple import SimpleApp

    loop = launch(SimpleApp, argv=[], window=Window(width=W, height=H), max_frames=2,
                  serve=0, device=CPU)
    assert loop.frames_rendered == 2
    assert not any(t.name == "zenith-viewer" and t.is_alive() for t in threading.enumerate())

"""tests/test_parallel_auto.py on the port: CompileOptions(parallel="auto")
picks sort-first or sort-last per graphic node at compile time from the
node's band hint (screen-row spans, GraphicNodeBuilder.set_band_hint).

The six cases of TestBandOccupancyHeuristic call the port's
``_auto_prefers_sort_last`` and the reference's on the same hints and
assert the reference's literals. The graph cases run the port over
``default_mesh(8, device="cpu")``, assert the reference's
``parallel_modes`` literals, and hold the frame against the port's
single-device frame and the JAX package's single-device frame (which the
reference's own auto frames are held to) at the reference's tolerance:
colour at most 0.2% of pixels off by > 1e-3, depth 1e-5 at the same share.
The harness is test_torch_sort_last.py's. One case beyond the reference's
flips the choice by the hint and finds the two frame functions cached
side by side.
"""

from __future__ import annotations

import numpy as np
import torch

from test_torch_sort_last import PORT, REF, assert_images_match, frame, single_node, tri_vb
from zenith_tpu.rendergraph import graph as ref_graph
from zenith_tpu_torch.rendergraph import graph as port_graph

torch.set_num_threads(1)

BIG = ref_graph.AUTO_SL_MIN_TRIS  # a load large enough to clear the minimum


def _both(hint, n):
    """The port's decision, held equal to the reference's."""
    got = port_graph._auto_prefers_sort_last(hint, n)
    assert got == ref_graph._auto_prefers_sort_last(hint, n), (hint, n)
    return got


# -- TestBandOccupancyHeuristic --------------------------------------------------------------


def test_clustered_load_prefers_sort_last():
    # Everything in the top eighth of the screen: one band holds the whole
    # load, 8x the uniform share.
    assert (port_graph.AUTO_SL_MIN_TRIS, port_graph.AUTO_SL_IMBALANCE) == (
        ref_graph.AUTO_SL_MIN_TRIS, ref_graph.AUTO_SL_IMBALANCE)
    assert _both([(BIG, 0.0, 0.125)], 8)


def test_uniform_load_stays_sort_first():
    assert not _both([(BIG, 0.0, 1.0)], 8)


def test_small_load_stays_sort_first_even_clustered():
    assert not _both([(BIG - 1, 0.0, 0.125)], 8)


def test_no_hint_or_single_shard():
    assert not _both(None, 8)
    assert not _both([], 8)
    assert not _both([(BIG, 0.0, 0.125)], 1)


def test_mixed_draws_aggregate():
    # A clustered heavy draw plus a light full-extent draw still clusters;
    # many uniform draws do not.
    assert _both([(BIG, 0.4, 0.5), (BIG // 16, 0.0, 1.0)], 8)
    assert not _both([(BIG // 4, 0.0, 1.0)] * 8, 8)


def test_out_of_range_spans_clamp():
    # Off-screen extents clamp into [0, 1] rather than skewing bands.
    assert _both([(BIG, -3.0, 0.125)], 8)
    assert not _both([(BIG, -3.0, 3.0)], 8)


# -- TestAutoModeGraph ---------------------------------------------------------------------


def _auto(draws, hint):
    """(port single-device, port auto over 8 shards, JAX single-device)
    outputs and the port's auto graph."""
    one, _ = frame(PORT, single_node(draws))
    eight, graph = frame(PORT, single_node(draws, hint=hint), 8, parallel="auto")
    ref, _ = frame(REF, single_node(draws))
    return one, eight, ref, graph


def _hold(one, eight, ref):
    for other in (one, ref):
        assert_images_match(eight[0], other[0], frac=0.002)
        assert_images_match(eight[1], other[1], tol=1e-5, frac=0.002)


def test_clustered_hint_takes_sort_last_and_matches_single(cpu_devices, rng):
    # Terrain-like: all geometry inside the top band (y in [-1, -0.75] NDC,
    # the top rows after the viewport flip).
    vb = tri_vb(rng, 48, y_range=(-1.0, -0.75))
    ib = rng.integers(0, 48, size=(30, 3)).astype(np.int32)
    one, eight, ref, graph = _auto([(vb, ib)], [(BIG, 0.0, 0.125)])
    assert graph.parallel_modes == {"scene": "sort_last"}
    assert one[0][..., :3].std() > 0.01
    _hold(one, eight, ref)


def test_uniform_hint_stays_sort_first_and_matches_single(cpu_devices, rng):
    vb = tri_vb(rng, 48)
    ib = rng.integers(0, 48, size=(30, 3)).astype(np.int32)
    one, eight, ref, graph = _auto([(vb, ib)], [(BIG, 0.0, 1.0)])
    assert graph.parallel_modes == {"scene": "sort_first"}
    _hold(one, eight, ref)


def test_hintless_node_stays_banded(cpu_devices, rng):
    vb = tri_vb(rng, 12)
    ib = np.arange(12, dtype=np.int32).reshape(-1, 3)
    one, eight, ref, graph = _auto([(vb, ib)], None)
    assert graph.parallel_modes == {"scene": "sort_first"}
    _hold(one, eight, ref)


def test_lazy_hint_callable_resolves_at_compile(cpu_devices, rng):
    vb = tri_vb(rng, 12, y_range=(-1.0, -0.75))
    ib = np.arange(12, dtype=np.int32).reshape(-1, 3)
    calls = []

    def lazy_hint():
        calls.append(1)
        return [(BIG, 0.0, 0.125)]

    one, eight, ref, graph = _auto([(vb, ib)], lazy_hint)
    assert calls, "lazy band hint was never evaluated in auto mode"
    assert graph.parallel_modes == {"scene": "sort_last"}
    _hold(one, eight, ref)


def test_hint_never_affects_single_chip(cpu_devices, rng):
    # Hints are performance metadata: without a mesh they must not re-key
    # or change the frame, and a lazy hint is never called.
    vb = tri_vb(rng, 12)
    ib = np.arange(12, dtype=np.int32).reshape(-1, 3)
    calls = []

    def lazy_hint():
        calls.append(1)
        return [(BIG, 0.0, 0.125)]

    a, _ = frame(PORT, single_node([(vb, ib)]))
    b, _ = frame(PORT, single_node([(vb, ib)], hint=[(BIG, 0.0, 0.125)]))
    c, graph = frame(PORT, single_node([(vb, ib)], hint=lazy_hint), parallel="auto")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[0], c[0])
    assert not calls and graph.parallel_modes == {}
    ref, _ = frame(REF, single_node([(vb, ib)]))
    assert_images_match(a[0], ref[0], frac=0.002)


def test_flipped_choice_switches_cached_frame_functions(cpu_devices, rng):
    """A camera move that flips a node's choice selects the other cached
    frame function, and flipping back hits the first again: the choices
    are in the key, so no stale function is served."""
    from zenith_tpu_torch.parallel import default_mesh
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rendergraph.graph import (
        clear_frame_program_cache,
        frame_program_cache_size,
    )
    from test_torch_sort_last import ns_of

    vb = tri_vb(rng, 12, y_range=(-1.0, -0.75))
    ib = np.arange(12, dtype=np.int32).reshape(-1, 3)
    ns = ns_of(PORT)
    device = ns.rhi.RhiCore(torch.device("cpu")).create_render_device()
    options = CompileOptions(tile_h=8, mesh=default_mesh(8, device="cpu"), parallel="auto")
    span = {"y1": 0.125}
    build = single_node([(vb, ib)], hint=lambda: [(BIG, 0.0, span["y1"])])
    clear_frame_program_cache()
    frames, modes, keys = [], [], []
    for y1 in (0.125, 1.0, 0.125):
        span["y1"] = y1
        builder = RenderGraphBuilder()
        color, depth = build(ns, builder)
        builder.export(color)
        graph = builder.build()
        compiled = graph.compile(device, ns.rhi.PipelineCache(), options)
        compiled.execute(device)
        frames.append(np.asarray(compiled.value(color)))
        modes.append(graph.parallel_modes["scene"])
        keys.append(compiled.key)
    assert modes == ["sort_last", "sort_first", "sort_last"]
    assert keys[0] == keys[2] and keys[0] != keys[1]
    assert frame_program_cache_size() == 2
    one, _ = frame(PORT, single_node([(vb, ib)]))
    for img in frames:
        assert_images_match(img, one[0], frac=0.002)

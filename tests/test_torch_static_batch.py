"""Static scene batching on the port (tests/test_static_batch.py's seven
cases): ``renderer.static_batch.StaticGeometryCache`` concatenates the
plain opaque draws' vertex and index buffers once, so that they ride one
buffer pair, and the batched frame must equal the per-object frame (the
same draws in the same order, indices unrebased).

The scenes are test_torch_renderers.py's translation of
test_renderers.build_test_scene (a cube over a ground quad, a 128² sun
shadow map, 128×64 with 8×128 tiles), and a ring of six cubes over the
ground. Each case asserts on the port what the reference's asserts:
ranges and concatenation, no batch for a single draw, the memo and its
invalidation by buffer identity, the fall-back for mixed strides, and
the deferred, forward and many-object frames equal with and without
batching. test_torch_renderers.py holds the deferred and the shadowed
forward frames of this scene against the reference package's, so no JAX
frame is built here.

Tolerance: the reference's (atol 1e-6 between the batched and the
per-object frames).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from test_torch_renderers import (  # noqa: F401  (device is a fixture)
    CPU,
    H,
    W,
    build_test_scene,
    device,
    make_camera,
    make_cube,
    run_graph,
)
from zenith_tpu_torch.renderer import (
    DeferredRenderer,
    DirectionalLight,
    ForwardShadowRenderer,
    Scene,
    SceneObject,
)
from zenith_tpu_torch.renderer.static_batch import StaticGeometryCache
from zenith_tpu_torch.rhi import TextureDesc
from zenith_tpu_torch.rhi.resource import Buffer, BufferDesc, BufferUsage

torch.set_num_threads(1)


class _NoStatic:
    def get(self, *a, **k):
        return None


def _disable_static(renderer):
    renderer._static_cache = _NoStatic()
    return renderer


def _render_deferred(device, renderer):
    cam = make_camera()

    def build(builder):
        out = builder.create(TextureDesc.color("out", W, H))
        renderer.render_to(builder, out, cam, W, H)
        return out

    return run_graph(device, build)


def _render_forward(device, renderer):
    cam = make_camera()

    def build(builder):
        out = builder.create(TextureDesc.color("out", W, H))
        depth = builder.create(TextureDesc.depth("depth", W, H))
        renderer.render_to(builder, out, depth, cam)
        return out

    return run_graph(device, build)


class TestStaticGeometryCache:
    def test_ranges_and_concat(self, device):
        scene = build_test_scene(device)
        geo = StaticGeometryCache().get(scene.objects, [0, 1])
        assert geo is not None
        (v0, vc0, i0, ic0), (v1, vc1, i1, ic1) = geo.ranges
        assert (v0, i0) == (0, 0)
        assert v1 == vc0 and i1 == ic0
        assert geo.vb.desc.shape[0] == vc0 + vc1
        assert geo.ib.desc.shape[0] == ic0 + ic1
        # Slices reproduce the originals exactly (indices unrebased).
        np.testing.assert_array_equal(geo.vb.array[v1:v1 + vc1].numpy(),
                                      scene.objects[1].vertex_buffer.array.numpy())
        np.testing.assert_array_equal(geo.ib.array[i1:i1 + ic1].numpy(),
                                      scene.objects[1].index_buffer.array.numpy())

    def test_single_draw_skips_batching(self, device):
        scene = build_test_scene(device)
        assert StaticGeometryCache().get(scene.objects, [0]) is None

    def test_memo_and_identity_invalidation(self, device):
        scene = build_test_scene(device)
        cache = StaticGeometryCache()
        geo1 = cache.get(scene.objects, [0, 1])
        assert cache.get(scene.objects, [0, 1]) is geo1  # memo hit
        # Swapping a buffer's identity (a hot reload) rebuilds.
        obj = scene.objects[0]
        obj.vertex_buffer = obj.vertex_buffer.with_array(obj.vertex_buffer.array)
        assert cache.get(scene.objects, [0, 1]) is not geo1

    def test_mixed_stride_falls_back(self, device):
        scene = build_test_scene(device)
        odd = SceneObject(
            name="odd",
            vertex_buffer=Buffer(BufferDesc("odd.vb", (3, 4), "float32", BufferUsage.VERTEX),
                                 device=CPU),
            index_buffer=Buffer(BufferDesc("odd.ib", (3,), "int32", BufferUsage.INDEX),
                                device=CPU),
            model_matrix=np.eye(4, dtype=np.float32),
        )
        assert StaticGeometryCache().get(scene.objects + [odd], [0, 1, 2]) is None


class TestBatchedEqualsPerObject:
    def test_deferred_scene_identical(self, device):
        scene = build_test_scene(device, num_lights=4)
        batched = _render_deferred(device, DeferredRenderer(scene))
        per_obj = _render_deferred(device, _disable_static(DeferredRenderer(scene)))
        np.testing.assert_allclose(batched, per_obj, atol=1e-6)

    def test_forward_scene_identical(self, device):
        scene = build_test_scene(device)
        batched = _render_forward(device, ForwardShadowRenderer(scene))
        per_obj = _render_forward(device, _disable_static(ForwardShadowRenderer(scene)))
        np.testing.assert_allclose(batched, per_obj, atol=1e-6)

    def test_many_objects_identical(self, device):
        """A ring of cubes and the ground: every record slices its own
        range of the concatenated buffers and lands in its own spot."""
        objs = []
        for k in range(6):
            a = 2 * math.pi * k / 6
            cube = SceneObject.from_mesh(
                device, make_cube(size=8.0, z0=6.0), f"cube{k}",
                base_color=(0.3 + 0.1 * k, 0.9 - 0.1 * k, 0.3, 1.0), bin_capacity=64)
            cube.model_matrix = np.asarray(
                [[1, 0, 0, 24 * math.cos(a)], [0, 1, 0, 24 * math.sin(a)], [0, 0, 1, 0],
                 [0, 0, 0, 1]], np.float32)
            objs.append(cube)
        objs.append(SceneObject.quad(device, "ground", size=200.0, z=0.0,
                                     base_color=(0.4, 0.4, 0.4, 1.0), roughness=0.9))
        scene = Scene(objects=objs, sun=DirectionalLight(direction=(0.05, -0.05, 1.0),
                                                         shadow_map_size=128,
                                                         shadow_extent=60.0))
        batched = _render_deferred(device, DeferredRenderer(scene))
        per_obj = _render_deferred(device, _disable_static(DeferredRenderer(scene)))
        np.testing.assert_allclose(batched, per_obj, atol=1e-6)
        # The batch engaged: the cache holds a 7-draw table.
        geo = DeferredRenderer(scene)._static_cache.get(scene.objects, list(range(7)))
        assert geo is not None and len(geo.ranges) == 7

"""Morph targets in the port (renderer/animation.sample_morph_weights, the
deferred renderer's morph stages, the procedural blob, the glTF bake of
targets and weights) against the reference package: twins of
tests/test_morph.py's six cases.

Tolerances: the sampled weights equal the reference's (the same NumPy
code); the morphed positions atol 1e-5 against the NumPy oracle (the
reference test's) and equal to the jitted reference's (measured: bit-equal);
the procedural and baked meshes equal the reference's arrays.
"""

import base64
import json

import jax
import numpy as np
import torch

from zenith_tpu_torch.asset import AssetUrl
from zenith_tpu_torch.asset.render_types import AnimationChannel, AnimationClip, Mesh
from zenith_tpu_torch.renderer.animation import sample_morph_weights

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_interpolates_and_loops():
    from zenith_tpu.asset import render_types as jrt
    from zenith_tpu.renderer.animation import sample_morph_weights as ref

    times = np.array([0.0, 1.0, 2.0], np.float32)
    values = np.array([[0, 0], [1, 0.5], [0, 0]], np.float32)
    clip = AnimationClip("pulse", [AnimationChannel(-1, "weights", times, values)], 2.0)
    jclip = jrt.AnimationClip("pulse", [jrt.AnimationChannel(-1, "weights", times, values)], 2.0)
    np.testing.assert_allclose(sample_morph_weights(clip, 0.5, 2), [0.5, 0.25])
    for t in (0.0, 0.5, 1.3, 2.5, 7.1):
        np.testing.assert_array_equal(sample_morph_weights(clip, t, 2), ref(jclip, t, 2))
    np.testing.assert_allclose(sample_morph_weights(clip, 2.5, 2),
                               sample_morph_weights(clip, 0.5, 2))


def test_no_weights_channel_is_zero():
    np.testing.assert_array_equal(sample_morph_weights(AnimationClip("empty", []), 1.0, 3),
                                  np.zeros(3, np.float32))


def test_matches_numpy_oracle(rng):
    from zenith_tpu.renderer.deferred import _morphed_position as ref
    from zenith_tpu_torch.renderer.deferred import _morphed_position

    n, t = 48, 3
    pos = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    deltas = rng.normal(size=(t, n, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (t,)).astype(np.float32)
    got = _morphed_position({"position": torch.from_numpy(pos)},
                            {"MorphWeights": torch.from_numpy(w),
                             "MorphDeltas": torch.from_numpy(deltas)}).numpy()
    np.testing.assert_allclose(got, pos + np.einsum("t,tnc->nc", w, deltas), atol=1e-5)
    want = jax.jit(lambda p, ww, d: ref({"position": p}, {"MorphWeights": ww,
                                                          "MorphDeltas": d}))(pos, w, deltas)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_morph_mesh_save_load(tmp_path):
    from zenith_tpu.sandbox.scene import morphing_blob as ref
    from zenith_tpu_torch.sandbox.scene import morphing_blob

    mesh = morphing_blob(rings=6, sides=8)
    jmesh = ref(rings=6, sides=8)
    for name in ("vertices", "indices", "morph_deltas"):
        np.testing.assert_array_equal(getattr(mesh, name), getattr(jmesh, name))
    assert mesh.num_morph_targets == 2
    mesh.save(tmp_path / "b.mesh")
    back = Mesh.load(AssetUrl("procedural/blob"), tmp_path / "b.mesh")
    np.testing.assert_array_equal(back.morph_deltas, mesh.morph_deltas)
    assert len(back.clips) == 1
    ch = back.clips[0].channels[0]
    assert ch.path == "weights" and ch.values.shape[1] == 2
    np.testing.assert_array_equal(ch.values, jmesh.clips[0].channels[0].values)


def _morph_gltf(path):
    """test_morph.py's glTF: a triangle at node translation (5, 0, 0), one
    POSITION target and a weights animation (0 → 1 over a second)."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    delta = np.array([[0, 0, 1], [0, 0, 2], [0, 0, 3]], np.float32)
    chunks = [pos.tobytes(), idx.tobytes(), delta.tobytes(),
              np.array([0.0, 1.0], np.float32).tobytes(),
              np.array([0.0, 1.0], np.float32).tobytes()]
    offsets, off = [], 0
    for chk in chunks:
        off = (off + 3) & ~3
        offsets.append(off)
        off += len(chk)
    blob = bytearray(off)
    for o, chk in zip(offsets, chunks):
        blob[o:o + len(chk)] = chk
    acc = [(5126, 3, "VEC3"), (5123, 3, "SCALAR"), (5126, 3, "VEC3"), (5126, 2, "SCALAR"),
           (5126, 2, "SCALAR")]
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [5, 0, 0]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1,
                                    "targets": [{"POSITION": 2}]}]}],
        "animations": [{"name": "pulse", "samplers": [{"input": 3, "output": 4}],
                        "channels": [{"sampler": 0, "target": {"node": 0, "path": "weights"}}]}],
        "accessors": [{"bufferView": i, "componentType": c, "count": n, "type": t}
                      for i, (c, n, t) in enumerate(acc)],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": len(chk)}
                        for o, chk in zip(offsets, chunks)],
        "buffers": [{"byteLength": len(blob), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(bytes(blob)).decode()}],
    }
    (path / "content" / "mo").mkdir(parents=True)
    (path / "content" / "mo" / "mo.gltf").write_text(json.dumps(doc))
    return delta


def test_bake_targets_and_weights_animation(tmp_path):
    import zenith_tpu.asset as jasset
    from zenith_tpu_torch import asset

    meshes = []
    for pkg, root in ((asset, tmp_path / "port"), (jasset, tmp_path / "ref")):
        delta = _morph_gltf(root)
        pkg.initialize()
        col = pkg.AssetManager(root=root).request_load("mo/mo.gltf").get()
        meshes.append(pkg.registry().get(pkg.AssetUrl(col.mesh_urls[0]), pkg.Mesh))
    mesh, jmesh = meshes
    assert mesh.num_morph_targets == 1
    # The node's translation is baked into the base vertices; the deltas are
    # directions: rotation applies (identity here), translation does not.
    np.testing.assert_allclose(mesh.vertices[0, :3], [5, 0, 0])
    np.testing.assert_allclose(mesh.morph_deltas[0], delta)
    ch = mesh.clips[0].channels[0]
    assert len(mesh.clips) == 1 and ch.path == "weights"
    np.testing.assert_allclose(ch.values, [[0.0], [1.0]])
    for name in ("vertices", "indices", "morph_deltas"):
        np.testing.assert_array_equal(getattr(mesh, name), getattr(jmesh, name))


def _render(weights):
    """test_morph.py's blob frame on the port: (HDR frame, (renderer,
    compiled graph, camera, device, object, output handle))."""
    from zenith_tpu_torch.core.camera import Camera
    from zenith_tpu_torch.core.mathtypes import Degree, Radians
    from zenith_tpu_torch.renderer import DeferredRenderer, DirectionalLight, Scene, SceneObject
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rhi import Format, PipelineCache, RhiCore, TextureDesc
    from zenith_tpu_torch.sandbox.scene import morphing_blob

    device = RhiCore(CPU).create_render_device()
    obj = SceneObject.from_mesh(device, morphing_blob(rings=10, sides=12), "blob",
                                base_color=(0.8, 0.5, 0.3, 1.0))
    if weights is not None:
        obj.morph_weights = np.asarray(weights, np.float32)
    scene = Scene(objects=[obj], sun=DirectionalLight(cast_shadows=True), point_lights=[],
                  ambient=(0.1, 0.1, 0.12))
    renderer = DeferredRenderer(scene)
    w, h = 128, 64
    camera = Camera(fov_y=Degree(35.0), aspect_ratio=w / h)
    camera.set_position(np.array([0.0, -60.0, 8.0], np.float32))
    camera.set_yaw_pitch(Radians(0.0), Radians(-0.1))
    builder = RenderGraphBuilder()
    out = builder.create(TextureDesc.color("out", w, h, Format.RGBA32F))
    builder.export(out)
    renderer.render_to(builder, out, camera, w, h)
    compiled = builder.build().compile(device, PipelineCache(), CompileOptions(tile_h=8))
    compiled.execute(device)
    return compiled.value(out).numpy(), (renderer, compiled, camera, device, obj, out)


def test_zero_weights_then_deform_and_retained():
    base, _ = _render(None)
    assert base[..., :3].std() > 0.01
    spike, (renderer, compiled, camera, device, obj, out) = _render([1.0, 0.0])
    assert np.abs(spike - base).max() > 0.05
    # A retained run with new weights: a change of dynamics only.
    obj.morph_weights = np.asarray([0.0, 1.0], np.float32)
    compiled.execute(device, dynamics=renderer.frame_dynamics(camera))
    assert np.abs(compiled.value(out).numpy() - spike).max() > 0.05

"""The port's asset pipeline (zenith_tpu_torch.asset) against the reference
package's: the registry and URL semantics, the save/load protocol, a
synthetic glTF (data-URI buffers; a normal, texture coordinates, a skin with
an animation, a morph target, a PNG texture when PIL is present) and its
GLB twin baked by both packages, the manager's cache and hot reload, and the
DDS container and BC1-BC5 decoders.

Tolerances: none. The asset code is host NumPy carried over as it is, so
baked arrays, decoded texels and metadata must be bit-equal. The port
raises ``ValueError`` / ``RuntimeError`` where the reference asserts on its
inputs.
"""

import base64
import json
import os
import struct
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import zenith_tpu.asset as jasset
import zenith_tpu.asset.dds as jdds
import zenith_tpu_torch.asset as tasset
import zenith_tpu_torch.asset.dds as tdds
from test_dds import make_dds
from zenith_tpu_torch.asset import (
    AssetManager,
    AssetUrl,
    Material,
    Mesh,
    MeshCollection,
    TextureAsset,
    TextureFormat,
    registry,
)
from zenith_tpu_torch.asset.render_types import AnimationChannel, AnimationClip, Skin

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_registries():
    for mod in (tasset, jasset):
        mod.initialize()
        mod.registry().clear()
    yield
    for mod in (tasset, jasset):
        mod.registry().clear()


def test_exports_equal_the_reference():
    assert sorted(tasset.__all__) == sorted(jasset.__all__)
    assert len(tasset.__all__) == 19


def test_registry_and_handles():
    mesh = Mesh(AssetUrl("m/a.mesh"), np.zeros((3, 8), np.float32), np.array([0, 1, 2]))
    handle = registry().register(mesh)
    assert handle.get().num_vertices == 3 and handle.try_get().get() is mesh
    assert registry().get(AssetUrl("m/a.mesh"), Mesh) is mesh
    assert registry().get(AssetUrl("m/a.mesh"), Material) is None  # keyed by type too
    assert registry().handle(AssetUrl("m/a.mesh"), Mesh) == handle and len(registry()) == 1
    registry().unregister(AssetUrl("m/a.mesh"), Mesh)
    assert registry().get(AssetUrl("m/a.mesh"), Mesh) is None and handle.try_get() is None
    with pytest.raises(KeyError):
        handle.get()


def test_url_semantics_match_the_reference():
    for path in ("mesh/cerberus/scene.gltf", "a.b/c.tex", "flat"):
        t, j = AssetUrl(path), jasset.AssetUrl(path)
        assert t.with_extension("mscl").path == j.with_extension("mscl").path
        assert t.sibling("x.png").path == j.sibling("x.png").path
        assert str(t) == str(j) and hash(t) == hash(AssetUrl(path))
    with pytest.raises(ValueError, match="relative"):
        AssetUrl("/absolute/banned")
    with pytest.raises(ValueError, match="pair"):
        MeshCollection(AssetUrl("c.mscl"), ["a"], ["x", "y"])


def test_registry_needs_initialize(monkeypatch):
    monkeypatch.setattr(tasset, "_REGISTRY", None)
    with pytest.raises(RuntimeError, match="initialize"):
        registry()


def _skinned_mesh(url="m/skin.mesh"):
    rng = np.random.default_rng(3)
    n = 6
    skin = Skin(np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)), np.array([-1, 0]),
                rng.normal(size=(2, 3)), np.tile([0, 0, 0, 1.0], (2, 1)), np.ones((2, 3)),
                pre=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)) * 2)
    clip = AnimationClip("wave", [
        AnimationChannel(1, "rotation", [0.0, 1.0], rng.normal(size=(2, 4))),
        AnimationChannel(0, "translation", [0.0, 0.5, 2.0], rng.normal(size=(3, 3)),
                         interpolation="STEP"),
        AnimationChannel(-1, "weights", [0.0, 1.0], rng.uniform(size=(2, 2))),
    ])
    return Mesh(AssetUrl(url), rng.uniform(size=(n, 8)).astype(np.float32),
                np.arange(6, dtype=np.int32), material_index=2,
                skin_vertex_data=rng.uniform(size=(n, 8)), skin=skin, clips=[clip],
                morph_deltas=rng.normal(size=(2, n, 3)))


def _material(url="m/m.mat"):
    rng = np.random.default_rng(4)
    px = rng.integers(0, 255, (4, 4, 4)).astype(np.uint8)
    return Material(AssetUrl(url), base_color_factor=(0.5, 0.25, 1.0, 1.0),
                    metallic_factor=0.7, roughness_factor=0.3, emissive_factor=(1, 2, 3),
                    base_color_texture=TextureAsset(AssetUrl("t.tex"), px),
                    normal_texture=TextureAsset(AssetUrl("n.tex"), px[..., :2],
                                                TextureFormat.RG8))


def _same_parts(a, b):
    """Two assets (of either package) hold bit-equal arrays and equal
    metadata."""
    aa, ba = a.arrays(), b.arrays()
    assert sorted(aa) == sorted(ba)
    for k in aa:
        assert aa[k].dtype == ba[k].dtype, k
        np.testing.assert_array_equal(aa[k], ba[k], err_msg=k)
    assert a.metadata() == b.metadata()


@pytest.mark.parametrize("make, kind", [
    (_skinned_mesh, "Mesh"), (_material, "Material"),
    (lambda: TextureAsset(AssetUrl("t.tex"), np.arange(12, dtype=np.uint8).reshape(2, 2, 3)),
     "TextureAsset"),
    (lambda: MeshCollection(AssetUrl("c.mscl"), ["a.mesh", "b.mesh"], ["m.mat", "m.mat"]),
     "MeshCollection"),
], ids=["skinned-mesh", "material", "texture", "collection"])
def test_save_load_round_trips_across_packages(tmp_path, make, kind):
    """The port's save → its own load and the reference's load; the
    reference's save → the port's load: the same arrays and metadata."""
    asset = make()
    asset.save(tmp_path / "a.npz")
    back = type(asset).load(asset.url, tmp_path / "a.npz")
    _same_parts(asset, back)
    jcls = getattr(jasset, kind)
    jback = jcls.load(jasset.AssetUrl(asset.url.path), tmp_path / "a.npz")
    _same_parts(back, jback)
    jback.save(tmp_path / "b.npz")
    _same_parts(back, type(asset).load(asset.url, tmp_path / "b.npz"))
    if kind == "Mesh":
        assert back.is_skinned and back.num_morph_targets == 2
        assert [c.interpolation for c in back.clips[0].channels] == ["LINEAR", "STEP", "LINEAR"]


def _png_data_uri() -> "str | None":
    try:
        from PIL import Image
    except ImportError:
        return None
    import io

    px = np.random.default_rng(9).integers(0, 255, (4, 6, 4)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _document(with_image: bool):
    """(glTF document, binary blob): two nodes, one a skinned and morphed
    quad with normals and texture coordinates under a parent's TRS, one an
    unindexed triangle without normals (flat normals baked) whose material
    has no entry; a scale/rotation animation on the skin's joints."""
    f32 = np.float32
    quad_pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], f32)
    quad_nrm = np.tile(np.array([[0, 0, 1]], f32), (4, 1))
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], f32)
    quad_idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    joints = np.array([[0, 1, 0, 0]] * 4, np.uint8)
    weights = np.array([[0.5, 0.5, 0, 0], [1, 0, 0, 0], [0.2, 0.6, 0, 0], [0, 1, 0, 0]], f32)
    inv_bind = np.stack([np.eye(4, dtype=f32), np.eye(4, dtype=f32)]).reshape(2, 16)
    morph = np.array([[0, 0, 0.1]] * 4, f32)
    tri_pos = np.array([[0, 0, 0], [2, 0, 0], [0, 3, 1]], f32)
    times = np.array([0.0, 1.0], f32)
    rots = np.array([[0, 0, 0, 1], [0, 0, 0.7071, 0.7071]], f32)
    scales = np.array([[1, 1, 1], [2, 2, 2]], f32)
    parts = [quad_pos, quad_nrm, quad_uv, quad_idx, joints, weights, inv_bind, morph, tri_pos,
             times, rots, scales]
    specs = [(5126, "VEC3"), (5126, "VEC3"), (5126, "VEC2"), (5123, "SCALAR"),
             (5121, "VEC4"), (5126, "VEC4"), (5126, "MAT4"), (5126, "VEC3"), (5126, "VEC3"),
             (5126, "SCALAR"), (5126, "VEC4"), (5126, "VEC3")]
    blob, views, accessors = b"", [], []
    for arr, (ctype, atype) in zip(parts, specs):
        blob += b"\0" * (-len(blob) % 4)
        raw = arr.tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(raw)})
        accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                          "count": int(arr.shape[0]), "type": atype})
        blob += raw
    accessors[5]["normalized"] = False
    material = {"pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.1, 0.2, 1.0],
                                         "metallicFactor": 0.4, "roughnessFactor": 0.6},
                "emissiveFactor": [0.5, 0.25, 0.0]}
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0, 4]}],
        "nodes": [
            {"children": [1, 2], "translation": [1.0, 2.0, 3.0], "scale": [2.0, 2.0, 2.0],
             "rotation": [0.0, 0.0, 0.3826834, 0.9238795]},
            {"mesh": 0, "skin": 0},
            {"children": [3], "translation": [0.0, 0.5, 0.0]},
            {"rotation": [0.0, 0.0, 0.0, 1.0], "scale": [1.0, 1.0, 1.0]},
            {"mesh": 1, "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 5, 6, 7, 1]},
        ],
        "skins": [{"joints": [3, 2], "inverseBindMatrices": 6}],
        "animations": [{"name": "grow", "channels": [
            {"sampler": 0, "target": {"node": 3, "path": "rotation"}},
            {"sampler": 1, "target": {"node": 2, "path": "scale"}},
            {"sampler": 2, "target": {"node": 1, "path": "weights"}}],
            "samplers": [{"input": 9, "output": 10}, {"input": 9, "output": 11,
                                                       "interpolation": "STEP"},
                         {"input": 9, "output": 9}]}],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2,
                                            "JOINTS_0": 4, "WEIGHTS_0": 5},
                             "indices": 3, "material": 0, "targets": [{"POSITION": 7}]}]},
            {"primitives": [{"attributes": {"POSITION": 8}, "material": 3}]},
        ],
        "materials": [material],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }
    uri = _png_data_uri() if with_image else None
    if uri is not None:
        doc["images"] = [{"uri": uri}]
        doc["textures"] = [{"source": 0}]
        material["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
        material["normalTexture"] = {"index": 0}
    return doc, blob


def _write_gltf(path: Path, with_image: bool):
    doc, blob = _document(with_image)
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(blob).decode())
    path.write_text(json.dumps(doc))


def _write_glb(path: Path, with_image: bool):
    doc, blob = _document(with_image)
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, total)
                     + struct.pack("<II", len(js), 0x4E4F534A) + js
                     + struct.pack("<II", len(blob), 0x004E4942) + blob)


def _bake_both(tmp_path, name, writer, with_image):
    content = tmp_path / "content" / "doc"
    content.mkdir(parents=True, exist_ok=True)
    writer(content / name, with_image)
    tcol = AssetManager(root=tmp_path, cache_dir=tmp_path / "tcache").request_load(
        f"doc/{name}").get()
    jcol = jasset.AssetManager(root=tmp_path, cache_dir=tmp_path / "jcache").request_load(
        f"doc/{name}").get()
    return tcol, jcol


@pytest.mark.parametrize("name, writer", [("scene.gltf", _write_gltf),
                                          ("scene.glb", _write_glb)], ids=["gltf", "glb"])
def test_bake_is_bit_equal_to_the_reference(tmp_path, name, writer):
    tcol, jcol = _bake_both(tmp_path, name, writer, with_image=True)
    _same_parts(tcol.get(), jcol.get())
    assert len(tcol.mesh_urls) == 2
    for url in tcol.mesh_urls:
        tm = registry().get(AssetUrl(url), Mesh)
        jm = jasset.registry().get(jasset.AssetUrl(url), jasset.Mesh)
        _same_parts(tm, jm)
    skinned = registry().get(AssetUrl(tcol.mesh_urls[0]), Mesh)
    assert skinned.is_skinned and skinned.clips and skinned.num_morph_targets == 1
    for url in dict.fromkeys(tcol.material_urls):
        _same_parts(registry().get(AssetUrl(url), Material),
                    jasset.registry().get(jasset.AssetUrl(url), jasset.Material))
    # The cached files are the same bytes' worth of arrays: each package's
    # cache loads in the other.
    for url in tcol.mesh_urls:
        _same_parts(jasset.Mesh.load(jasset.AssetUrl(url), tmp_path / "tcache" / url),
                    Mesh.load(AssetUrl(url), tmp_path / "jcache" / url))


def test_gltf_and_glb_twins_bake_the_same(tmp_path):
    a, _ = _bake_both(tmp_path, "scene.gltf", _write_gltf, with_image=False)
    b, _ = _bake_both(tmp_path, "scene.glb", _write_glb, with_image=False)
    for ua, ub in zip(a.mesh_urls, b.mesh_urls):
        np.testing.assert_array_equal(registry().get(AssetUrl(ua), Mesh).vertices,
                                      registry().get(AssetUrl(ub), Mesh).vertices)


def test_manager_cache_rebake_and_hot_reload(tmp_path):
    content = tmp_path / "content" / "doc"
    content.mkdir(parents=True)
    _write_gltf(content / "scene.gltf", with_image=False)
    mgr = AssetManager(root=tmp_path)
    col = mgr.request_load("doc/scene.gltf").get()
    manifest = tmp_path / "cache" / "doc" / "scene.mscl"
    mtime = manifest.stat().st_mtime_ns
    registry().clear()
    mgr.request_load("doc/scene.gltf")  # cache hit: no rebake
    assert manifest.stat().st_mtime_ns == mtime
    assert registry().get(AssetUrl(col.mesh_urls[0]), Mesh).is_skinned
    seen = []
    mgr.watch("doc/scene.gltf", on_reload=seen.append)
    assert mgr.poll_hot_reload() == []
    later = time.time() + 5
    os.utime(content / "scene.gltf", (later, later))
    assert [str(u) for u in mgr.poll_hot_reload()] == ["doc/scene.gltf"]
    assert len(seen) == 1 and seen[0].get() is not None
    assert manifest.stat().st_mtime_ns > mtime
    assert mgr.poll_hot_reload() == []
    with pytest.raises(ValueError, match="no baker"):
        mgr.request_load("doc/other.obj")


def test_loader_names_malformed_containers(tmp_path):
    from zenith_tpu_torch.asset.gltf_loader import GltfLoader

    for name, raw, match in (
        ("v1.glb", b"glTF" + b"\x01\x00\x00\x00" + b"\x00" * 32, "version"),
        ("trunc.glb", b"glTF\x02\x00", "truncated"),
        ("nojson.glb", struct.pack("<III", 0x46546C67, 2, 12), "JSON"),
    ):
        (tmp_path / name).write_bytes(raw)
        with pytest.raises(ValueError, match=match):
            GltfLoader.load(str(tmp_path / name))


# -- DDS ----------------------------------------------------------------------


@pytest.mark.parametrize("mode, block, channels", [
    ("bc1", 8, 4), ("bc2", 16, 4), ("bc3", 16, 4), ("bc4", 8, 1), ("bc5", 16, 2)])
def test_bc_decoders_are_bit_equal_to_the_reference(mode, block, channels):
    rng = np.random.default_rng(len(mode) + block)
    raw = rng.integers(0, 256, size=(11 * 7, block), dtype=np.uint8)
    # Force both BC1/alpha palette modes: c0 > c1 and c0 <= c1, a0 > a1 and a0 <= a1.
    raw[::2, 0], raw[::2, 1] = 200, 10
    raw[1::2, 0], raw[1::2, 1] = 10, 200
    data = raw.tobytes()
    for w, h in ((44, 28), (43, 26)):  # whole blocks, and cropped ones
        t = getattr(tdds, f"decode_{mode}")(data, w, h)
        j = getattr(jdds, f"decode_{mode}")(data, w, h)
        assert t.shape == j.shape == (h, w, channels) and t.dtype == j.dtype == np.uint8
        np.testing.assert_array_equal(t, j)


def _mips(fourcc, block, w, h, levels, rng):
    out = b""
    for _ in range(levels):
        out += rng.integers(0, 256, ((w + 3) // 4) * ((h + 3) // 4) * block,
                            dtype=np.uint8).tobytes()
        w, h = max(1, w // 2), max(1, h // 2)
    return out


_RNG = np.random.default_rng(12)
_DDS_CASES = {
    "legacy-dxt5-mips": make_dds(b"DXT5", 16, 8, 3, _mips(b"DXT5", 16, 16, 8, 3, _RNG)),
    "legacy-dxt1-mips": make_dds(b"DXT1", 8, 8, 2, _mips(b"DXT1", 8, 8, 8, 2, _RNG)),
    "dx10-bc1-srgb": make_dds(b"DX10", 8, 8, 1, _mips(b"", 8, 8, 8, 1, _RNG),
                              dx10=(72, 3, 0, 1, 0)),
    "dx10-bc5": make_dds(b"DX10", 12, 4, 1, _mips(b"", 16, 12, 4, 1, _RNG),
                         dx10=(83, 3, 0, 1, 0)),
    "cube-bc4": make_dds(b"ATI1", 4, 4, 1, _mips(b"", 8, 4, 4, 6, _RNG)[:48],
                         caps2=0x200 | 0xFE00),
    "cube-dxt1": make_dds(b"DXT1", 4, 4, 1, _mips(b"", 8, 4, 4, 6, _RNG)[:48],
                          caps2=0x200 | 0xFE00),
}
_DDS_ERRORS = {
    "bad-magic": (b"notadds" + bytes(200), "magic"),
    "bc7": (make_dds(b"DX10", 4, 4, 1, bytes(16), dx10=(98, 3, 0, 1, 0)), "BC6H/"),
    "truncated": (make_dds(b"DXT1", 16, 16, 1, bytes(10)), "truncated"),
    "partial-cube": (make_dds(b"DXT1", 4, 4, 1, bytes(48), caps2=0x200 | 0x0400), "partial"),
    "fourcc": (make_dds(b"XYZW", 4, 4, 1, bytes(16)), "FourCC"),
}


@pytest.mark.parametrize("case", sorted(_DDS_CASES))
def test_dds_container_parses_as_the_reference(case):
    t, j = tdds.parse_dds(_DDS_CASES[case]), jdds.parse_dds(_DDS_CASES[case])
    assert (t.width, t.height, t.mode, t.srgb, t.is_cube, t.mip_count, t.channels) == \
        (j.width, j.height, j.mode, j.srgb, j.is_cube, j.mip_count, j.channels)
    assert len(t.faces) == len(j.faces) == (6 if t.is_cube else 1)
    for tf, jf in zip(t.faces, j.faces):
        for tm, jm in zip(tf, jf):
            np.testing.assert_array_equal(tm, jm)
    ta, ja = t.to_texture_asset(f"{case}.tex"), j.to_texture_asset(f"{case}.tex")
    assert isinstance(ta.url, AssetUrl) and ta.format.value == ja.format.value
    np.testing.assert_array_equal(ta.pixels, ja.pixels)
    tex = t.to_texture(case, device=CPU)
    if t.is_cube:
        assert tex.desc.array_layers == 6 and tex.array.shape == (6, 4, 4, 4)
    else:
        assert tex.desc.mip_levels == t.mip_count
        ref = j.to_texture(case)
        for k, level in enumerate(tex.mips or [tex.array]):
            assert level.device == CPU
            np.testing.assert_array_equal(
                level.numpy(), np.asarray((ref.mips or [ref.array])[k]))


@pytest.mark.parametrize("case", sorted(_DDS_ERRORS))
def test_dds_container_refuses_as_the_reference(case):
    raw, match = _DDS_ERRORS[case]
    with pytest.raises(ValueError, match=match):
        tdds.parse_dds(raw)
    with pytest.raises(ValueError, match=match):
        jdds.parse_dds(raw)


def test_dds_uncompressed_is_refused():
    raw = bytearray(make_dds(b"\0\0\0\0", 4, 4, 1, bytes(64)))
    raw[80:84] = struct.pack("<I", 0x40)  # DDPF_RGB: no FOURCC flag
    with pytest.raises(ValueError, match="uncompressed"):
        tdds.parse_dds(bytes(raw))
    with pytest.raises(TypeError):
        tdds.parse_dds(_DDS_CASES["legacy-dxt1-mips"]).to_texture("no-device")

"""The rest of PostProcess in the port (ops/aa.py, renderer/post.py's grade,
film and auto-exposure) against the reference package on the same
numpy-seeded inputs, and the film golden through the port.

Tolerances: the LDR ops (FXAA, both halves of the grade, the film chain
with and without chromatic aberration) atol 1e-6 against the jitted
reference (the frame compiles them); the film grain's hash bits equal;
the adapted exposure over three fed-back frames rtol 1e-5 (2M-pixel
log-average reductions sum in another order in torch; rtol 1e-5 holds at
these 128×64 frames too) and its LDR frames atol 1e-5; the film golden
≤ 1 LSB with < 1% of values differing (the golden tolerance). The SPMD
cases (test_aa.py:80, test_autoexposure.py:139, test_film.py:156 and :174,
test_grade.py:78; tests/test_torch_spmd_twins.py): the banded chain or post
node over 8 row bands at the reference's tolerance against single-device
(each case states it) and against the JAX 8-device result.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from zenith_tpu_torch.ops.aa import post_aa
from zenith_tpu_torch.ops.ssao import _pixel_hash_bits
from zenith_tpu_torch.renderer.post import (
    ColorGrade,
    FilmEffects,
    PostProcess,
    apply_film,
    apply_grade_post,
    apply_grade_pre,
)
from zenith_tpu_torch.rhi import RhiCore

torch.set_num_threads(1)
CPU = torch.device("cpu")
GOLDEN_DIR = Path(__file__).parent / "golden"
H, W = 64, 128


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _ldr(rng, h=37, w=51):
    """An LDR image with hard edges (FXAA's gate opens on them)."""
    img = rng.uniform(0.0, 1.0, (h, w, 4)).astype(np.float32)
    img[h // 3:, : w // 2, :3] = 0.9
    img[: h // 2, w // 2:, :3] *= 0.1
    return img


def test_fxaa_matches_the_reference(rng):
    from zenith_tpu.ops.aa import post_aa as ref

    img = _ldr(rng)
    for kw in ({}, dict(strength=0.5, threshold=0.03)):
        got = post_aa(torch.from_numpy(img), **kw).numpy()
        want = np.asarray(jax.jit(lambda x: ref(x, **kw))(img))
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert np.abs(got - img).max() > 0.05  # the gate opened
    np.testing.assert_allclose(post_aa(torch.from_numpy(img[..., :3])).numpy(),
                               np.asarray(jax.jit(ref)(img[..., :3])), atol=1e-6)


def test_grade_matches_the_reference(rng):
    from zenith_tpu.renderer import post as ref

    g = ColorGrade(exposure_ev=0.15, contrast=1.08, saturation=1.12, temperature=0.35,
                   tint=-0.05, vignette=0.45).pack()
    hdr = rng.uniform(0.0, 4.0, (37, 51, 3)).astype(np.float32)
    hdr[0, :4] = 0.0  # the contrast's zero branch
    got = apply_grade_pre(torch.from_numpy(hdr), torch.from_numpy(g)).numpy()
    want = np.asarray(jax.jit(ref.apply_grade_pre)(hdr, g))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ldr = _ldr(rng)[..., :3]
    for row0, full_h in ((0, None), (5, 80)):
        got = apply_grade_post(torch.from_numpy(ldr), torch.from_numpy(g), row0, full_h).numpy()
        want = np.asarray(jax.jit(lambda m, v: ref.apply_grade_post(m, v, row0, full_h))(ldr, g))
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("ca,sharpen", [(0.0, 0.4), (2.5, 0.0)])
def test_film_matches_the_reference(rng, ca, sharpen):
    """Sharpen and grain, and the aberration with grain, each at atol 1e-6.
    Both together are the film golden's (≤ 1 LSB): the sharpen multiplies
    the aberration's last ulps of a resample coordinate by 1 + 4·0.4."""
    from zenith_tpu.renderer import post as ref

    film = FilmEffects(chromatic_aberration=ca, sharpen=sharpen, grain=0.035)
    for _ in range(3):
        f = film.pack()  # seed 3
    ldr = _ldr(rng)[..., :3]
    got = apply_film(torch.from_numpy(ldr), torch.from_numpy(f), ca > 0.0).numpy()
    want = np.asarray(jax.jit(lambda m, v: ref.apply_film(m, v, ca > 0.0))(ldr, f))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(got - ldr).max() > 0.01


def test_film_grain_bits_equal_the_reference():
    from zenith_tpu.ops.ssao import _pixel_hash_bits as ref

    for seed in (0, 7, 4095):
        got = _pixel_hash_bits(45, 70, 3, seed=torch.tensor(float(seed)), device=CPU).numpy()
        want = np.asarray(ref(45, 70, np.uint32(3), seed=np.float32(seed).astype(np.uint32)))
        np.testing.assert_array_equal(got, want.astype(np.int32))


def test_packed_values_and_capture_keys_equal_the_reference():
    from zenith_tpu.renderer import ColorGrade as JGrade, FilmEffects as JFilm

    from zenith_tpu_torch import interop

    kw = dict(exposure_ev=0.2, contrast=1.1, saturation=0.9, temperature=-0.3, tint=0.1,
              vignette=0.3)
    np.testing.assert_array_equal(ColorGrade(**kw).pack(), JGrade(**kw).pack())
    film, jfilm = FilmEffects(2.0, 0.3, 0.05, 0.7), JFilm(2.0, 0.3, 0.05, 0.7)
    for _ in range(2):
        np.testing.assert_array_equal(film.pack(), jfilm.pack())
    assert film.__zenith_capture_key__() == jfilm.__zenith_capture_key__()
    np.testing.assert_array_equal(interop.film_from(jfilm).pack(), jfilm.pack())
    np.testing.assert_array_equal(interop.color_grade_from(JGrade(**kw)).pack(),
                                  JGrade(**kw).pack())


def _hdr_frames(rng):
    """Three HDR frames: a lit scene, the same, then 40x brighter."""
    base = rng.uniform(0.0, 1.5, (H, W, 4)).astype(np.float32)
    base[..., 3] = 1.0
    base[10:30, 20:60, :3] = 6.0
    bright = base.copy()
    bright[..., :3] *= 40.0
    return [base, base, bright]


def _jax_run(post, frames):
    from zenith_tpu.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu.rhi import PipelineCache, RhiCore as JCore, TextureDesc

    device = JCore().create_render_device()
    out_imgs, exposures = [], []
    for img in frames:
        builder = RenderGraphBuilder()
        hdr = builder.create(TextureDesc.color("hdr", W, H))
        out = builder.create(TextureDesc.color("out", W, H))
        builder.export(out)
        builder.set_dynamic("src", img)
        gen = builder.add_lambda_node("gen")
        hdr_w = gen.write(hdr)
        gen.execute(lambda ctx, hdr_w=hdr_w: ctx.set(hdr_w, ctx.dynamic("src")))
        post.render_to(builder, hdr, out)
        compiled = builder.build().compile(device, PipelineCache(), CompileOptions(tile_h=8))
        compiled.execute(device)
        e = compiled.value(post.exposure_out)
        post.feedback(e)
        out_imgs.append(np.asarray(compiled.value(out)))
        exposures.append(float(np.asarray(e)[0]))
    return out_imgs, exposures


def _port_run(post, frames):
    """Each frame rebuilds the graph with the fed-back exposure (the
    engine's rebuild path); the last frame also re-runs retained with
    ``frame_dynamics``, which must give the same exposure (the film's grain
    seed moves on). Returns the LDR
    frames, the exposures and each frame's frame function."""
    from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
    from zenith_tpu_torch.rhi import PipelineCache, TextureDesc

    device = RhiCore(CPU).create_render_device()
    cache = PipelineCache()
    out_imgs, exposures, fns = [], [], []
    for img in frames:
        builder = RenderGraphBuilder()
        hdr = builder.create(TextureDesc.color("hdr", W, H))
        out = builder.create(TextureDesc.color("out", W, H))
        builder.export(out)
        builder.set_dynamic("src", img)
        gen = builder.add_lambda_node("gen")
        hdr_w = gen.write(hdr)
        gen.execute(lambda ctx, hdr_w=hdr_w: ctx.set(hdr_w, ctx.dynamic("src")))
        post.render_to(builder, hdr, out)
        compiled = builder.build().compile(device, cache, CompileOptions(tile_h=8))
        state = post._ae_state
        compiled.execute(device)
        e = compiled.value(post.exposure_out)
        assert isinstance(e, torch.Tensor) and tuple(e.shape) == (1,)
        out_imgs.append(compiled.value(out).numpy().copy())
        exposures.append(float(e[0]))
        fns.append(compiled._fn)
        post.feedback(e)
    post.feedback(state)
    compiled.execute(device, dynamics={"src": frames[-1], **post.frame_dynamics()})
    assert float(compiled.value(post.exposure_out)[0]) == exposures[-1]
    return out_imgs, exposures, fns


@pytest.mark.parametrize("bloom_mips", [0, 3])
def test_auto_exposure_feeds_back_like_the_reference(rng, bloom_mips):
    """Three frames, the exposure fed back as a device value each time, on
    the single-node and the mip-chain post, with FXAA, grade and film on
    top: the exposures rtol 1e-5 and the frames atol 1e-5 of the JAX
    package's; one frame function serves all three (frame 0's placeholder
    state has the fed-back state's shape and dtype)."""
    from zenith_tpu.renderer import ColorGrade as JGrade, FilmEffects as JFilm
    from zenith_tpu.renderer import PostProcess as JPost

    from zenith_tpu_torch import interop

    frames = _hdr_frames(rng)
    kw = dict(auto_exposure=True, bloom_mips=bloom_mips, fxaa=True)
    jpost = JPost(**kw, grade=JGrade(contrast=1.1, vignette=0.3),
                  film=JFilm(sharpen=0.3, grain=0.03))
    jpost.set_delta_time(0.25)
    post = interop.post_process_from(jpost)
    assert post.__zenith_capture_key__() == jpost.__zenith_capture_key__()
    want_imgs, want_e = _jax_run(jpost, frames)
    got_imgs, got_e, fns = _port_run(post, frames)
    np.testing.assert_allclose(got_e, want_e, rtol=1e-5)
    assert got_e[2] < got_e[1] and got_e[2] > 0.18 / 40.0  # adapting, not snapped
    for got, want in zip(got_imgs, want_imgs):
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert fns[0] is fns[1] is fns[2]


def test_film_golden_through_the_port():
    from zenith_tpu_torch.sandbox.scene import FEATURE_GOLDENS, feature_golden_frame

    assert "film" in FEATURE_GOLDENS
    img = feature_golden_frame(RhiCore(CPU).create_render_device(), "film").numpy()
    golden = np.load(GOLDEN_DIR / "feat_film_128x64.npy")
    assert img.shape == golden.shape == (64, 128, 4) and img.dtype == np.uint8
    d = np.abs(img.astype(np.int16) - golden.astype(np.int16))
    assert int(d.max()) <= 1 and float((d > 0).mean()) < 0.01, (int(d.max()), (d > 0).mean())


# -- the SPMD cases (tests/test_torch_spmd_twins.py) -----------------------------------


def _banded_chain(x, pkg_ref, **kw):
    """tone_and_bloom_banded of an (H', W, 4) frame over 8 row bands in the
    port (spmd.shard_map) or the reference (jax.shard_map)."""
    if pkg_ref:
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as JP

        from zenith_tpu.parallel import default_mesh as ref_mesh
        from zenith_tpu.renderer.post import tone_and_bloom_banded as ref_banded

        kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        return np.asarray(jax.jit(jax.shard_map(
            lambda v: ref_banded(v, "rows", **kw), mesh=ref_mesh(8, backend="cpu"),
            in_specs=JP("rows"), out_specs=JP("rows")))(jnp.asarray(x)))
    from zenith_tpu_torch.parallel import default_mesh, spmd
    from zenith_tpu_torch.renderer.post import tone_and_bloom_banded

    kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return spmd.shard_map(lambda v: tone_and_bloom_banded(v, "rows", **kw),
                          default_mesh(8, device="cpu"), in_specs=spmd.P("rows"),
                          out_specs=spmd.P("rows"))(torch.from_numpy(x)).full().numpy()


def test_spmd_banded_fxaa_bit_equal(cpu_devices):
    """test_aa.py:80: FXAA through the banded chain (its 1-row reach sits
    inside the halo) equals the single-device chain, at the reference's
    atol 2e-5 + rtol 1e-6, and the JAX banded chain at atol 1e-6."""
    from zenith_tpu_torch.renderer.post import tone_and_bloom

    hdr = np.random.default_rng(1).uniform(0.0, 3.0, (128, 64, 4)).astype(np.float32)
    single = tone_and_bloom(torch.from_numpy(hdr), fxaa=True).numpy()
    banded = _banded_chain(hdr, False, fxaa=True)
    np.testing.assert_allclose(banded, single, atol=2e-5, rtol=1e-6)
    np.testing.assert_allclose(banded, _banded_chain(hdr, True, fxaa=True), atol=1e-6)


def test_spmd_banded_vignette_matches_single(cpu_devices):
    """test_grade.py:78: the vignette uses global rows under a mesh, so the
    bands concatenate to the single-device image (the reference's atol
    1e-5); the JAX banded chain at atol 1e-6."""
    from zenith_tpu_torch.renderer.post import tone_and_bloom

    hdr = np.random.default_rng(7).uniform(0.0, 2.0, size=(256, 128, 4)).astype(np.float32)
    grade = ColorGrade(exposure_ev=0.3, contrast=1.1, saturation=1.2, temperature=0.4,
                       vignette=0.6).pack()
    single = tone_and_bloom(torch.from_numpy(hdr), grade=torch.from_numpy(grade)).numpy()
    banded = _banded_chain(hdr, False, grade=grade)
    np.testing.assert_allclose(banded, single, atol=1e-5)
    np.testing.assert_allclose(banded, _banded_chain(hdr, True, grade=grade), atol=1e-6)


def _post_graph(h2, w2, fn, **post_kw):
    """(planes, add) of a generated HDR frame through PostProcess(**post_kw)
    (``film`` a factory: FilmEffects advances its seed as it packs)."""
    from test_torch_spmd_twins import grid

    rows, cols = grid(h2, w2)
    planes = {"hdr": fn(rows, cols)}

    def add(pkg, builder, h):
        post_mod = pkg.mod("renderer.post")
        kw = dict(post_kw)
        if "film" in kw:
            kw["film"] = kw["film"](post_mod.FilmEffects)
        post = post_mod.PostProcess(**kw)
        out = builder.create(pkg.mod("rhi").TextureDesc.color("ldr", w2, h2))
        post.render_to(builder, h["hdr"], out)
        outs = [out]
        if post.exposure_out is not None:
            outs.append(post.exposure_out)
        return outs

    return planes, add


def test_spmd_sharded_metering_matches_single(cpu_devices):
    """test_autoexposure.py:139: the banded post node averages the
    log-luminance over the bands, so every band adapts identically: the
    exposure rtol 1e-5 and the frame atol 1e-5 against single-device (the
    reference's tolerances) and against the JAX 8-device frame."""
    from test_torch_spmd_twins import triplet

    def hdr(rows, cols):
        base = 0.05 + 2.0 * np.exp(-((rows - 97.0) ** 2 + (cols - 41.0) ** 2) / 900.0)
        return np.stack([base, base * 0.6, base * 0.3, np.ones_like(base)], -1)

    planes, add = _post_graph(256, 128, hdr, auto_exposure=True)
    (img1, e1), (img8, e8), (jimg, je) = triplet(planes, add)
    np.testing.assert_allclose(e8, e1, rtol=1e-5)
    np.testing.assert_allclose(img8, img1, atol=1e-5)
    np.testing.assert_allclose(e8, je, rtol=1e-5)
    np.testing.assert_allclose(img8, jimg, atol=1e-5)


def _film_hdr(rows, cols):
    c = np.maximum(0.3 + 0.5 * np.sin(rows * 0.4) * np.cos(cols * 0.1), 0.0)
    return np.stack([c, c * 0.8, 1.0 - c * 0.5, np.ones_like(c)], -1)


@pytest.mark.parametrize("path", ["ca_gather", "halo"])
def test_spmd_film_matches_single_device(cpu_devices, path):
    """test_film.py:156 and :174: chromatic aberration takes the gather-full
    path under a mesh; without it the halo path carries the sharpen and the
    grain (the grain hash over global rows). Both equal single-device at
    the reference's atol 1e-5, and the JAX 8-device frame at atol 1e-5."""
    from test_torch_spmd_twins import triplet

    def film(cls):
        if path == "ca_gather":
            f = cls(chromatic_aberration=3.0, sharpen=0.4, grain=0.03)
            f._seed = 100  # the same seed every run (pack advances it)
        else:
            f = cls(sharpen=0.5, grain=0.05)
            f._seed = 7
        return f

    planes, add = _post_graph(H, W, _film_hdr, film=film)
    (img1,), (img8,), (jimg,) = triplet(planes, add)
    np.testing.assert_allclose(img8, img1, atol=1e-5)
    np.testing.assert_allclose(img8, jimg, atol=1e-5)

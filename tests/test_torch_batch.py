"""The port's draw_indexed_batch against the reference's on the same
numpy-seeded draws: 2 draws (per-draw uniforms rebuilt by the draw-id
``where`` chain) and 10 draws (uniforms carried in the records), with an
instanced draw inside the batch, a ``PerDraw`` fragment binding selected by
``builtins.draw_id``. (The graph context's batched draw runs in
tests/test_torch_deferred.py.)

Tolerances: coverage and the bin overflow count exact; colors atol 1e-5;
depth atol 1e-5 (XLA's CPU backend contracts the reference kernel's
multiply-adds into FMAs, the port rounds each product; ROADMAP §3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zenith_tpu.ops.draw as jdraw_mod
import zenith_tpu_torch.ops.draw as tdraw_mod
from zenith_tpu.ops import TileGrid as JGrid
from zenith_tpu.rhi import pipeline as jpipe, shader as jshader, state as jstate
from zenith_tpu.rhi.formats import Format as JFormat
from zenith_tpu_torch.ops import TileGrid as TGrid
from zenith_tpu_torch.rhi import pipeline as tpipe, shader as tshader, state as tstate
from zenith_tpu_torch.rhi.formats import Format as TFormat

torch.set_num_threads(1)
W, H = 128, 64
JG = JGrid(W, H, 8, 128)
TG = TGrid(W, H, 8, 128)


def _vs(xp):
    def vs(attrs, res):
        p = attrs["position"]
        off = attrs["offset"] if "offset" in attrs else 0.0 * p
        return {"position": (p + off) @ res["Model"].T, "color": attrs["color"]}
    return vs


def _fs(xp, where, cat):
    def fs(v, res, b):
        # Tint: a per-draw uniform plane; Gain: a PerDraw tuple selected by
        # the draw id.
        gains = res["Gain"]
        if b.draw_id is None:  # a single draw: its own (1,) value
            gain = gains[0] + 0.0 * v["color"][..., 0]
        else:
            gain = gains[0][0] + 0.0 * b.draw_id
            for i in range(1, len(gains)):
                gain = where(abs(b.draw_id - i) < 0.5, gains[i][0], gain)
        c = v["color"] * res["Tint"][..., :3] * gain[..., None]
        return cat([c, res["Tint"][..., 3:4] + 0.0 * c[..., :1]], -1)
    return fs


def _pipelines():
    out = []
    for pm, sm, st, fmt, xp in (
        (jpipe, jshader, jstate, JFormat, jnp),
        (tpipe, tshader, tstate, TFormat, torch),
    ):
        where = jnp.where if xp is jnp else torch.where
        cat = jnp.concatenate if xp is jnp else torch.cat
        out.append(pm.GraphicPipeline(pm.GraphicPipelineDesc(
            shader_input=pm.GraphicShaderInput(
                sm.Shader.vertex("batch.vs", _vs(xp), bindings=[sm.uniform("Model")]),
                sm.Shader.fragment("batch.fs", _fs(xp, where, cat),
                                   bindings=[sm.uniform("Tint"), sm.uniform("Gain")]),
                st.VertexLayout.from_fields(("position", 4), ("color", 3)),
            ),
            state=st.GraphicPipelineState(
                rasterization=st.RasterizationState(cull_mode=st.CullMode.NONE),
                depth_stencil=st.DepthStencilDesc().reverse_z(),
            ),
            attachments=st.GraphicPipelineAttachments(
                color_formats=(fmt.RGBA32F,), depth_format=fmt.D32F),
        )))
    return out


def _draws(n, seed, instanced_at=None):
    rng = np.random.default_rng(seed)
    draws = []
    for d in range(n):
        # Well-shaped triangles with their own corners (no slivers, whose
        # inv_det would amplify the reference's FMA rounding in z).
        nt = 6
        ang = rng.uniform(0, 2 * np.pi, (nt, 1)) + np.array([0.0, 2.1, 4.2]) \
            + rng.uniform(-0.3, 0.3, (nt, 3))
        rad = rng.uniform(0.25, 0.6, (nt, 1))
        ctr = rng.uniform(-0.7, 0.7, (nt, 1, 2))
        xy = (ctr + rad[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)).reshape(-1, 2)
        nv = 3 * nt
        w = rng.uniform(0.8, 1.5, (nv, 1))
        z = rng.uniform(0.05, 0.95, (nv, 1)) * w
        vb = np.concatenate([xy * w, z, w, rng.uniform(0, 1, (nv, 3))], 1).astype(np.float32)
        ib = np.arange(nv, dtype=np.int32).reshape(nt, 3)
        model = np.eye(4, dtype=np.float32)
        model[:2, 3] = rng.uniform(-0.2, 0.2, 2)
        res = {"Model": model, "Tint": rng.uniform(0.2, 1.0, 4).astype(np.float32),
               "Gain": np.array([0.5 + 0.1 * d], np.float32)}
        inst = None
        if d == instanced_at:
            offs = np.zeros((3, 4), np.float32)
            offs[:, 0] = [-0.3117, 0.0473, 0.2791]
            inst = {"instance_count": 3, "instance_data": {"offset": offs}}
        draws.append((vb, ib, res, inst))
    return draws


def _run(n, seed, instanced_at=None):
    jp, tp = _pipelines()
    draws = _draws(n, seed, instanced_at)
    per_draw = ("Tint",)
    bg = np.random.default_rng(99).uniform(0, 1, (H, W, 4)).astype(np.float32)
    z0 = np.full((H, W), 0.02, np.float32)

    def pack(xp_arr, arrays):
        """Draw tuples from per-draw (vb, ib, model, tint, gain, offsets)."""
        out = []
        for (vb, ib, model, tint, gain, offs), (_, _, _, inst) in zip(arrays, draws):
            r = {"Model": xp_arr(model), "Tint": xp_arr(tint), "Gain": xp_arr(gain)}
            if inst is None:
                out.append((xp_arr(vb), xp_arr(ib), r))
            else:
                out.append((xp_arr(vb), xp_arr(ib), r, {
                    "instance_count": inst["instance_count"],
                    "instance_data": {"offset": xp_arr(offs)}}))
        return out

    host = [(vb, ib, res["Model"], res["Tint"], res["Gain"],
             None if inst is None else inst["instance_data"]["offset"])
            for vb, ib, res, inst in draws]

    def jrun(bg_, z_, arrays):
        cols, dep, stats = jdraw_mod.draw_indexed_batch(
            [bg_], z_, jp, pack(jnp.asarray, arrays), JG, per_draw_uniforms=per_draw)
        return cols[0], dep, stats.bin_overflow

    jc, jd, jover = jax.jit(jrun)(jnp.asarray(bg), jnp.asarray(z0), host)
    tc, td, ts = tdraw_mod.draw_indexed_batch(
        [torch.from_numpy(bg)], torch.from_numpy(z0), tp,
        pack(lambda a: None if a is None else torch.from_numpy(a), host), TG,
        per_draw_uniforms=per_draw)
    jcol, tcol = np.asarray(jc), tc[0].numpy()
    np.testing.assert_array_equal(np.any(tcol != bg, -1), np.any(jcol != bg, -1))  # coverage
    np.testing.assert_allclose(tcol, jcol, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    assert int(ts.bin_overflow) == int(jover)
    covered = np.any(tcol != bg, -1)
    assert covered.mean() > 0.2  # the draws really drew
    return tcol, covered


@pytest.mark.parametrize("n", [2, 10], ids=["draw-id-where-chain", "uniforms-in-records"])
def test_batch_matches_the_reference(n):
    _run(n, seed=n, instanced_at=1)


def test_batch_equals_the_draws_one_by_one_when_nothing_overlaps():
    """Records keep submission order across draws: with depth test off and
    disjoint draws, the batch and a chain of single draws agree exactly."""
    _, tp = _pipelines()
    rng = np.random.default_rng(3)
    draws = []
    for d in range(3):
        x0 = -0.9 + 0.6 * d
        vb = np.array([[x0, -0.8, 0.5, 1, 1, 0, 0], [x0 + 0.5, -0.8, 0.5, 1, 0, 1, 0],
                       [x0 + 0.2, 0.7, 0.5, 1, 0, 0, 1]], np.float32)
        res = {"Model": torch.eye(4), "Tint": torch.from_numpy(rng.uniform(0.3, 1, 4).astype(np.float32)),
               "Gain": torch.tensor([1.0])}
        draws.append((torch.from_numpy(vb), torch.tensor([0, 1, 2], dtype=torch.int32), res))
    bg = torch.zeros((H, W, 4))
    z0 = torch.full((H, W), 0.02)
    cols, _, _ = tdraw_mod.draw_indexed_batch([bg], z0, tp, draws, TG, per_draw_uniforms=("Tint",))
    one = [bg]
    for vb, ib, res in draws:
        one, _, _ = tdraw_mod.draw_indexed(one, z0, tp, vb, ib, res, TG)
    np.testing.assert_array_equal(cols[0].numpy(), one[0].numpy())


def test_unported_batch_modes_name_their_roadmap_item():
    _, tp = _pipelines()
    vb = torch.from_numpy(_draws(1, 5)[0][0])
    ib = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    res = {"Model": torch.eye(4), "Tint": torch.ones(4), "Gain": torch.ones(1)}
    # Peeling needs a blending pipeline. Multisampling (ROADMAP item 18) is
    # ported: a batch draws per sample (test_torch_msaa.py holds it to the
    # reference); a sample count without standard positions is refused.
    with pytest.raises(ValueError, match="requires a blending pipeline"):
        tdraw_mod.draw_indexed_batch([torch.zeros((H, W, 4))], None, tp, [(vb, ib, res)], TG,
                                     peel_layers=2)

    def with_samples(n):
        return tpipe.GraphicPipeline(dataclasses.replace(
            tp.desc, state=dataclasses.replace(
                tp.desc.state, multisample=tstate.MultisampleState(samples=n))))

    bg = torch.zeros((4, H, W, 4))
    draws = [(torch.from_numpy(v), torch.from_numpy(i), {k: torch.from_numpy(x)
                                                         for k, x in r.items()})
             for v, i, r, _ in _draws(2, 5)]
    batch, _, _ = tdraw_mod.draw_indexed_batch([bg], None, with_samples(4), draws, TG,
                                               per_draw_uniforms=("Tint",))
    assert batch[0].shape == (4, H, W, 4)
    coverage = (batch[0][..., 3] > 0).float().mean(0)
    assert bool(((coverage > 0) & (coverage < 1)).any())  # edges covered by some samples
    with pytest.raises(NotImplementedError, match="1/2/4/8 samples"):
        with_samples(3)

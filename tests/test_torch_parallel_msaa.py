"""tests/test_parallel.py's TestMSAAPersistenceUnderMesh on the port: a
two-node 4x MSAA chain (the second node LOADs colour and depth) rendered
in row bands over ``default_mesh(8, device="cpu")``, held at atol 1e-6
against the port's single-device frame and against the JAX 8-device frame
(per-sample coverage of two slivers: no contracted product moves it). A
file of its own beside test_torch_parallel_frames.py, so that neither runs
much over 30 s: the JAX frame compiles for ~15-20 s.
"""

from __future__ import annotations

import numpy as np
import torch

from test_torch_spmd_twins import CPU, jax_mesh, run_graph
from zenith_tpu_torch.parallel import default_mesh

torch.set_num_threads(1)


# -- TestMSAAPersistenceUnderMesh ----------------------------------------------------------------


def _msaa_chain(pkg, mesh):
    """Two thin slivers crossing in an X over the full height at different
    depths, drawn by two 4x MSAA nodes (the second LOADs colour and depth):
    per-sample planes must persist per band across the node boundary."""
    import importlib
    from dataclasses import replace

    rhi = importlib.import_module(f"{pkg}.rhi")
    st = importlib.import_module(f"{pkg}.rhi.state")
    jax_side = pkg == "zenith_tpu"
    if jax_side:
        import jax.numpy as jnp

        white = lambda v, r, b: jnp.broadcast_to(jnp.asarray((1.0, 1.0, 1.0, 1.0)),  # noqa: E731
                                                 b.depth.shape + (4,))
        kw = {}
    else:
        white = lambda v, r, b: torch.ones(  # noqa: E731
            b.depth.shape + (4,), device=b.depth.device)
        kw = dict(device=CPU)
    w2, h2 = 128, 128  # 8 shards x 16-row bands
    vs = rhi.Shader.vertex("msaa.vs", lambda attrs, res: {"position": attrs["position"]})
    fs = rhi.Shader.fragment("msaa.fs", white)
    tri_a = np.array([[-0.95, -0.95, 0.5, 1], [0.95, 0.95, 0.5, 1], [-0.95, -0.80, 0.5, 1]],
                     np.float32)
    tri_b = np.array([[-0.95, 0.95, 0.7, 1], [0.95, -0.95, 0.7, 1], [0.95, -0.80, 0.7, 1]],
                     np.float32)
    vba = rhi.Buffer.from_numpy("ma.vb", tri_a, **kw)
    vbb = rhi.Buffer.from_numpy("mb.vb", tri_b, **kw)
    ib = rhi.Buffer.from_numpy("m.ib", np.array([0, 1, 2], np.int32), **kw)
    layout = rhi.VertexLayout.from_fields(("position", 4))
    state = st.GraphicPipelineState(
        rasterization=rhi.RasterizationState(cull_mode=rhi.CullMode.NONE),
        depth_stencil=st.DepthStencilDesc().reverse_z(),
        multisample=rhi.MultisampleState(samples=4),
    )

    def build(builder):
        ra, rb, ri = (builder.import_resource(b) for b in (vba, vbb, ib))
        out = builder.create(rhi.TextureDesc.color("m.rt", w2, h2))
        dep = builder.create(rhi.TextureDesc.depth("m.ds", w2, h2))
        builder.export(out)

        def add_node(name, vhandle, first):
            node = builder.add_graphic_node(name)
            va, ia = node.read(vhandle), node.read(ri)
            rt, ds = node.write(out), node.write(dep)
            with node.pipeline(rhi.GraphicShaderInput(vs, fs, layout), state) as b:
                if first:
                    b.push_color(rt, rhi.ColorAttachmentDesc(clear_value=(0, 0, 0, 1)))
                    b.set_depth(ds, st.DepthStencilDesc().reverse_z())
                else:
                    b.push_color(rt, rhi.ColorAttachmentDesc(load_op=st.LoadOp.LOAD))
                    b.set_depth(ds, replace(st.DepthStencilDesc().reverse_z(),
                                            depth_load_op=st.LoadOp.LOAD))
            node.execute(lambda ctx, va=va, ia=ia: ctx.draw_indexed(va, ia))

        add_node("pass1", ra, first=True)
        add_node("pass2", rb, first=False)
        return (out,)

    return run_graph("jax" if jax_side else "port", build, mesh)[0]


def test_mesh_msaa_chain_bit_equal_to_single_device(cpu_devices):
    single = _msaa_chain("zenith_tpu_torch", None)
    sharded = _msaa_chain("zenith_tpu_torch", default_mesh(8, device="cpu"))
    vals = single[..., 0]
    # Fractional edge coverage exists in most 16-row bands.
    bands_with_edges = sum(((vals[b * 16:(b + 1) * 16] > 0.1)
                            & (vals[b * 16:(b + 1) * 16] < 0.9)).sum() > 4 for b in range(8))
    assert bands_with_edges >= 6, bands_with_edges
    np.testing.assert_allclose(sharded, single, atol=1e-6)
    np.testing.assert_allclose(sharded, _msaa_chain("zenith_tpu", jax_mesh()), atol=1e-6)

"""The shared harness of the port's SPMD twins (the reference's TestSPMD
cases in tests/test_{aa,autoexposure,contact,dof,film,flare,grade,hud,
motion_blur,ssao,ssr,taa,velocity,volumetric}.py, on the port); it holds
no test of its own, as tests/test_torch_shadow_frames.py does not.

``frame(pkg, planes, add, mesh_n)`` builds one render graph in ``pkg``
("zenith_tpu_torch" or "zenith_tpu"): a "gen" lambda node writes each named
full-surface numpy plane as the shard's row band (the plane rides a
dynamic; a 2-D plane is a depth texture, a 3-D one a colour texture), the
way the reference's cases generate their inputs from global rows; then
``add(pkg_ns, builder, handles)`` declares the pass under test and returns
the handles to read. With ``mesh_n`` the graph runs in row bands over
``default_mesh(mesh_n, device="cpu")`` (the port) or ``default_mesh(mesh_n,
backend="cpu")`` (the reference, tests/conftest.py's virtual devices).
``triplet`` returns the port's single-device and banded frames and the
JAX banded frame of the same graph.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

CPU = torch.device("cpu")
PORT, REF = "zenith_tpu_torch", "zenith_tpu"


class Pkg:
    """A package's modules by their sub-path (``ns.mod("renderer")``)."""

    def __init__(self, name: str):
        self.name = name
        self.is_ref = name == REF

    def mod(self, sub: str):
        return importlib.import_module(f"{self.name}.{sub}")


def device_of(pkg: Pkg):
    rhi = pkg.mod("rhi")
    return rhi.RhiCore().create_render_device() if pkg.is_ref else \
        rhi.RhiCore(CPU).create_render_device()


def mesh_of(pkg: Pkg, n: "int | None"):
    if n is None:
        return None
    if pkg.is_ref:
        return pkg.mod("parallel").default_mesh(n, backend="cpu")
    return pkg.mod("parallel").default_mesh(n, device="cpu")


def band_of(ctx, full, is_ref: bool):
    """The shard's row band of a full-height value (all of it unsharded)."""
    if not ctx.sharded:
        return full
    bh = full.shape[0] // ctx.num_shards
    if is_ref:
        import jax

        return jax.lax.dynamic_slice_in_dim(
            full, jax.lax.axis_index(ctx.shard_axis) * bh, bh, 0)
    from zenith_tpu_torch.parallel import spmd

    r0 = spmd.axis_index(ctx.shard_axis) * bh
    return full[r0:r0 + bh]


def frame(pkg_name: str, planes: "dict[str, np.ndarray]", add, mesh_n: "int | None" = None,
          dynamics: "dict | None" = None, tile_w: int = 128) -> list:
    pkg = Pkg(pkg_name)
    rg, rhi = pkg.mod("rendergraph"), pkg.mod("rhi")
    if pkg.is_ref:
        from zenith_tpu.rendergraph.graph import clear_frame_program_cache

        clear_frame_program_cache()
    device = device_of(pkg)
    builder = rg.RenderGraphBuilder()
    handles = {}
    for name, arr in planes.items():
        h, w = arr.shape[:2]
        make = rhi.TextureDesc.depth if arr.ndim == 2 else rhi.TextureDesc.color
        handles[name] = builder.create(make(name, w, h))
        builder.set_dynamic(f"gen.{name}", np.ascontiguousarray(arr, np.float32))
    for k, v in (dynamics or {}).items():
        builder.set_dynamic(k, v)
    gen = builder.add_lambda_node("gen")
    writes = {name: gen.write(h) for name, h in handles.items()}
    is_ref = pkg.is_ref

    def record_gen(ctx):
        for name, w_ in writes.items():
            ctx.set(w_, band_of(ctx, ctx.dynamic(f"gen.{name}"), is_ref))

    gen.execute(record_gen)
    outs = add(pkg, builder, handles)
    for o in outs:
        builder.export(o)
    compiled = builder.build().compile(
        device, rhi.PipelineCache(),
        rg.CompileOptions(tile_h=8, tile_w=tile_w, mesh=mesh_of(pkg, mesh_n)))
    compiled.execute(device)
    return [np.asarray(compiled.value(o)) for o in outs]


def triplet(planes, add, **kw):
    """(port single-device, port 8-band, JAX 8-band) outputs of one graph."""
    return (frame(PORT, planes, add, None, **kw), frame(PORT, planes, add, 8, **kw),
            frame(REF, planes, add, 8, **kw))


def grid(h: int, w: int):
    """(rows, cols) float32 index planes of an (h, w) surface."""
    rows, cols = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                             indexing="ij")
    return rows, cols


def jax_mesh():
    """The reference's 8-device CPU mesh (tests/conftest.py's devices)."""
    from zenith_tpu.parallel import default_mesh as ref_mesh

    return ref_mesh(8, backend="cpu")


def run_graph(pkg, build, mesh):
    """Build a graph with ``build(builder)`` (returns the handles to read)
    in ``pkg`` and run one frame on its CPU device."""
    if pkg == "jax":
        from zenith_tpu.rendergraph import CompileOptions as JOptions
        from zenith_tpu.rendergraph import RenderGraphBuilder as JBuilder
        from zenith_tpu.rendergraph.graph import clear_frame_program_cache
        from zenith_tpu.rhi import PipelineCache as JCache
        from zenith_tpu.rhi import RhiCore as JCore

        clear_frame_program_cache()
        device = JCore().create_render_device()
        builder = JBuilder()
        handles = build(builder)
        compiled = builder.build().compile(device, JCache(),
                                           JOptions(tile_h=8, tile_w=128, mesh=mesh))
    else:
        from zenith_tpu_torch.rendergraph import CompileOptions, RenderGraphBuilder
        from zenith_tpu_torch.rhi import PipelineCache, RhiCore

        device = RhiCore(CPU).create_render_device()
        builder = RenderGraphBuilder()
        handles = build(builder)
        compiled = builder.build().compile(device, PipelineCache(),
                                           CompileOptions(tile_h=8, tile_w=128, mesh=mesh))
    compiled.execute(device)
    return [np.asarray(compiled.value(h)) for h in handles]

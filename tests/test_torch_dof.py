"""Depth of field in the port (renderer/dof.py) against the reference
package: twins of tests/test_dof.py's four TestBlend cases, each on the same
numpy inputs through the jitted reference and the port, plus the
reference's own assertions on the port's result, and the SPMD case (the
DoF node over 8 row bands, tests/test_torch_spmd_twins.py).

Tolerance: the blended frame atol 1e-6 against the jitted reference (the
rolls, means and tent weights round the same float32 operations); the
banded frame the reference's atol 1e-5 against single-device.
"""

import jax
import numpy as np
import pytest
import torch

from zenith_tpu_torch.renderer.dof import dof_blend

torch.set_num_threads(1)
H, W = 64, 128


def _pattern():
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    r = 0.5 + 0.5 * np.sin(xs * 0.9)  # high-frequency stripes
    return np.stack([r, 1.0 - r, r * 0.5, np.ones_like(r)], -1).astype(np.float32)


def _both(hdr, dist, params):
    """(port, reference) blends of the same inputs, the port's held to the
    reference's at atol 1e-6."""
    from zenith_tpu.renderer.dof import dof_blend as ref

    params = np.asarray(params, np.float32)
    got = dof_blend(torch.from_numpy(hdr), torch.from_numpy(dist),
                    torch.from_numpy(params)).numpy()
    want = np.asarray(jax.jit(ref)(hdr, dist, params))
    np.testing.assert_allclose(got, want, atol=1e-6)
    return got


def test_in_focus_is_untouched():
    hdr = _pattern()
    out = _both(hdr, np.full((H, W), 100.0, np.float32), [100.0, 20.0, 1.5, 0.0])
    np.testing.assert_allclose(out, hdr, atol=1e-5)


def test_defocus_blurs_high_frequencies():
    hdr = _pattern()
    out = _both(hdr, np.full((H, W), 100.0, np.float32), [10.0, 5.0, 1.5, 0.0])
    # The stripes' contrast collapses under the deep pyramid levels.
    assert out[..., 0].std() < 0.35 * hdr[..., 0].std()


def test_sky_focuses_at_infinity():
    hdr = _pattern()
    # Focused near: the sky (distance 0, at infinity) is defocused most.
    out = _both(hdr, np.zeros((H, W), np.float32), [10.0, 5.0, 1.5, 0.0])
    assert out[..., 0].std() < 0.35 * hdr[..., 0].std()


@pytest.mark.parametrize("focus", [5.0, 50.0, 100.0, 400.0])
def test_tent_weights_partition_energy(focus):
    """A uniform colour stays uniform at any level of detail (the weights
    sum to 1: no brightness pumping as the focus racks); a seeded random
    distance plane blends levels differently per pixel."""
    hdr = np.full((H, W, 4), 0.6, np.float32)
    out = _both(hdr, np.full((H, W), 100.0, np.float32), [focus, 10.0, 1.5, 0.0])
    np.testing.assert_allclose(out[..., :3], 0.6, atol=1e-4)
    dist = np.random.default_rng(int(focus)).uniform(0.0, 300.0, (H, W)).astype(np.float32)
    _both(_pattern(), dist, [focus, 10.0, 1.5, 0.0])


def test_spmd_banded_matches_single(cpu_devices):
    """tests/test_dof.py::TestSPMD: the DoF node over 8 row bands gathers,
    blurs and slices back, equal to single-device at the reference's atol
    1e-5, and to the JAX 8-device frame at 1e-6 (as the blend above)."""
    from test_torch_spmd_twins import grid, triplet

    h2, w2 = 256, 128
    rows, cols = grid(h2, w2)
    base = 0.5 + 0.5 * np.sin(cols * 0.8) * np.cos(rows * 0.3)
    dd = 5.0 + rows * 0.4  # the distance ramps with the global row
    z = np.zeros_like(dd)
    planes = {"hdr": np.stack([base, 1.0 - base, base, np.ones_like(base)], -1),
              "gpos": np.stack([dd, z, z, z], -1), "gdep": np.full((h2, w2), 0.5, np.float32)}

    def add(pkg, builder, h):
        dof = pkg.mod("renderer.dof").DepthOfField(focus_distance=20.0, focal_range=5.0,
                                                    strength=1.5)
        out = builder.create(pkg.mod("rhi").TextureDesc.color("out", w2, h2))
        dof.render_to(builder, h["hdr"], out, {"pos": h["gpos"], "depth": h["gdep"]})
        return [out]

    (img1,), (img8,), (jimg,) = triplet(planes, add,
                                        dynamics={"def.camera_pos": np.zeros(3, np.float32)})
    assert img1[..., :3].std() > 0.01
    np.testing.assert_allclose(img8, img1, atol=1e-5)
    np.testing.assert_allclose(img8, jimg, atol=1e-6)

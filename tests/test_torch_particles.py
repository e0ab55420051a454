"""Particles in the port (renderer/particles.py) against the reference
package: the respawn hash bit-equal, twins of tests/test_particles.py's
four step cases on the same numpy inputs through the jitted reference, and
its engine-loop case through the port's SceneApp.

Tolerances: the hash's bits equal over ids 0..2**20 at eight ticks and over
ticks 0..10**4 at 128 ids; each step's positions, z velocities, ages and
lives atol 1e-6 against the jitted reference (its multiply-adds round once,
as XLA contracts them); the x and y velocities of respawned particles,
cos and sin of the hash angle times a radius up to 14, atol 2e-6 (XLA's
float32 sin and cos approximations differ from torch's by up to one ulp:
measured ≤ 1.9e-6 over 65,536 particles, ROADMAP §3).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from zenith_tpu_torch.renderer.particles import _STATE_COLS, _hash01, particle_step

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _alive_state(p):
    st = np.zeros((p, _STATE_COLS), np.float32)
    st[:, 0] = np.linspace(-5, 5, p)  # x
    st[:, 2] = 20.0  # z, well above the ground
    st[:, 3:6] = [1.0, 0.0, 2.0]  # velocity
    st[:, 6] = 0.1  # age
    st[:, 7] = 10.0  # life (does not expire this step)
    return st


def _step(st, dt, tick, emitter, **kw):
    """The port's step, held to the jitted reference's on the same inputs."""
    from zenith_tpu.renderer.particles import particle_step as ref

    emitter = np.asarray(emitter, np.float32)
    got = particle_step(torch.from_numpy(st), torch.tensor(dt, dtype=torch.float32),
                        torch.tensor(tick, dtype=torch.float32), emitter, **kw).numpy()
    want = np.asarray(jax.jit(lambda s, d, t, e: ref(s, d, t, e, **kw))(
        st, np.float32(dt), np.float32(tick), emitter))
    cols = [0, 1, 2, 5, 6, 7]
    np.testing.assert_allclose(got[:, cols], want[:, cols], atol=1e-6)
    np.testing.assert_allclose(got[:, 3:5], want[:, 3:5], atol=2e-6)
    return got


def test_hash_is_bit_equal_to_the_reference():
    from zenith_tpu.renderer.particles import _hash01 as ref

    jref = jax.jit(ref)
    ids = np.arange(1 << 20, dtype=np.int32)
    for tick in (0.0, 1.0, 2.0, 7.0, 977.0, 4095.0, 9999.0, 10000.0):
        got = _hash01(torch.from_numpy(ids), torch.tensor(tick)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(jref(ids, np.float32(tick))).view(np.uint32))
    few = np.arange(128, dtype=np.int32)
    ticks = np.arange(10001, dtype=np.float32)
    got = torch.vmap(lambda t: _hash01(torch.from_numpy(few), t))(torch.from_numpy(ticks))
    want = jax.jit(jax.vmap(lambda t: ref(few, t)))(ticks)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_gravity_integration_matches_closed_form():
    st = _alive_state(16)
    dt = 0.02
    out = _step(st, dt, 3.0, [0.0, 0.0, 2.0], gravity=-35.0, drag=0.12)
    vel = st[:, 3:6] * (1.0 - 0.12 * dt) + np.array([0, 0, -35.0]) * dt
    np.testing.assert_allclose(out[:, 3:6], vel, atol=1e-5)
    np.testing.assert_allclose(out[:, 0:3], st[:, 0:3] + vel * dt, atol=1e-5)
    np.testing.assert_allclose(out[:, 6], st[:, 6] + dt, atol=1e-6)


def test_ground_bounce_reflects():
    st = _alive_state(4)
    st[:, 2] = 0.05  # about to cross the ground
    st[:, 5] = -10.0  # falling
    out = _step(st, 0.05, 1.0, [0.0, 0.0, 2.0], bounce=0.45)
    assert np.all(out[:, 2] >= 0.0)  # reflected above the ground
    assert np.all(out[:, 5] > 0.0)  # z velocity flipped upward


def test_respawn_at_emitter_and_determinism():
    st = _alive_state(32)
    st[:, 6] = 100.0  # everyone past their life: respawn
    a = _step(st, 0.016, 5.0, [7.0, -3.0, 2.0])
    b = _step(st, 0.016, 5.0, [7.0, -3.0, 2.0])
    np.testing.assert_array_equal(a, b)  # hash randomness is reproducible
    np.testing.assert_allclose(a[:, 0:3], np.tile([7.0, -3.0, 2.0], (32, 1)), atol=1e-5)
    np.testing.assert_allclose(a[:, 6], 0.0)  # age reset
    assert np.all(a[:, 7] > 0.0)  # fresh life
    assert np.all(a[:, 5] > 0.0)  # launched upward
    assert np.std(a[:, 3]) > 0.1  # velocities vary across particles


def test_different_tick_different_respawn():
    st = _alive_state(8)
    st[:, 6] = 100.0
    a = _step(st, 0.016, 1.0, [0.0, 0.0, 0.0])
    b = _step(st, 0.016, 2.0, [0.0, 0.0, 0.0])
    assert np.abs(a[:, 3:6] - b[:, 3:6]).max() > 0.05


def test_compute_node_feedback_and_instanced_draw(monkeypatch):
    """The whole loop in SceneApp: the sim's compute node, its exported
    state fed back every frame, the instanced draw at the device positions:
    the positions move, one frame function, the state a tensor throughout."""
    from zenith_tpu_torch import asset
    from zenith_tpu_torch.launch import launch
    from zenith_tpu_torch.rendergraph.graph import (
        clear_frame_program_cache,
        frame_program_cache_size,
    )
    from zenith_tpu_torch.sandbox.scene import SceneApp
    from zenith_tpu_torch.window import Window

    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("ZENITH_CACHE", str(ROOT / "cache"))
    monkeypatch.delenv("ZENITH_CONTENT", raising=False)
    asset.initialize()
    clear_frame_program_cache()
    seen = []

    class App(SceneApp):
        def on_frame_outputs(self, outputs):
            super().on_frame_outputs(outputs)
            if "psys.pos" in outputs:
                seen.append(outputs["psys.pos"].numpy().copy())

    loop = launch(App, argv=["--", "--mode", "deferred", "--lights", "2", "--particles", "16",
                             "--no-post"], window=Window(width=128, height=64, title="t"),
                  max_frames=4, device="cpu")
    assert frame_program_cache_size() == 1
    assert len(seen) == 4 and loop.app.psys._tick == 4
    assert loop.app.renderer.velocity  # device offsets turn the velocity plane on
    assert np.abs(seen[1] - seen[0]).max() > 1e-4  # the sim advances
    assert np.abs(seen[3] - seen[2]).max() > 1e-4
    assert np.isfinite(seen[-1]).all()

"""Particles simulated on the device: a compute node in the frame function
(torch port of zenith_tpu/renderer/particles.py).

The state lives on the device; a compute node integrates it every frame
(gravity, drag, a ground bounce, a hash-based respawn: all elementwise and
of fixed shape), and the instanced draw renders the previous frame's
positions (one frame of sim-to-draw latency keeps both in one frame
function with no host round trip).

The state crosses frames on the engine's feedback path, as TAA's history
does: the stepped state and its (P, 3) positions are exported,
``RenderContext.request_output`` hands them back, and the next frame takes
them as dynamics. The respawn randomness is a per-particle integer hash
salted by the frame tick, so the system is deterministic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from zenith_tpu_torch.rendergraph import RenderGraphBuilder
from zenith_tpu_torch.renderer.post import _fma
from zenith_tpu_torch.rhi.resource import BufferDesc

# State row: pos.xyz, vel.xyz, age, life.
_STATE_COLS = 8
_MASK32 = 0xFFFFFFFF


def _hash01(ids: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Per-particle uniform [0, 1) from an integer hash (particles.py:33-41).
    The reference's uint32 products wrap mod 2**32; here they run on int64
    (every product stays below 2**63) and are masked back to 32 bits, so
    the bits are equal. ``salt`` is a float32 scalar: ``salt * 977``
    truncates to an integer as the reference's cast does."""
    a = (ids.to(torch.int64) * 374761393) & _MASK32
    b = ((salt * 977.0).to(torch.int64) * 668265263) & _MASK32
    n = (a + b) & _MASK32
    n = ((n ^ (n >> 13)) * 1274126177) & _MASK32
    n = n ^ (n >> 16)
    return (n & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def particle_step(state: torch.Tensor, dt: torch.Tensor, tick: torch.Tensor, emitter,
                  gravity: float = -35.0, drag: float = 0.12, ground_z: float = 0.0,
                  bounce: float = 0.45, spread: float = 14.0, up_speed: float = 42.0,
                  life: float = 2.5) -> torch.Tensor:
    """One step over the (P, 8) state (particles.py:44-96); ``dt`` and
    ``tick`` are float32 scalars, ``emitter`` three host floats. Constant
    vectors enter as Python floats, column by column, so the step copies
    nothing from the host."""
    p = state.shape[0]
    ids = torch.arange(p, dtype=torch.int32, device=state.device)
    pos = state[:, 0:3]
    vel = state[:, 3:6]
    age = state[:, 6]
    plife = torch.clamp(state[:, 7], min=1e-3)

    # These multiply-adds round once, as XLA's CPU jit contracts them
    # (renderer.post._fma).
    scale = 1.0 - drag * dt
    vel = torch.stack([vel[:, 0] * scale, vel[:, 1] * scale,
                       _fma(vel[:, 2], scale, gravity * dt)], dim=1)
    pos = _fma(vel, dt, pos)
    # The ground bounce, with energy loss.
    below = pos[:, 2] < ground_z
    pos = torch.stack([pos[:, 0], pos[:, 1],
                       torch.where(below, 2.0 * ground_z - pos[:, 2], pos[:, 2])], dim=1)
    vel = torch.stack([vel[:, c] * torch.where(below, f, 1.0)
                       for c, f in enumerate((0.8, 0.8, -bounce))], dim=1)
    age = age + dt

    # Respawn: a hash-random launch cone from the emitter.
    dead = age >= plife
    r0 = _hash01(ids, tick)
    r1 = _hash01(ids + p, tick)
    r2 = _hash01(ids + 2 * p, tick)
    ang = r0 * (2.0 * math.pi)
    rad = torch.sqrt(r1) * spread
    new_vel = torch.stack([torch.cos(ang) * rad, torch.sin(ang) * rad,
                           up_speed * _fma(r2, 0.7, 0.65)], dim=1)
    new_life = life * _fma(r0, 0.8, 0.6)
    pos = torch.stack([torch.where(dead, float(e), pos[:, c])
                       for c, e in enumerate(emitter)], dim=1)
    vel = torch.where(dead[:, None], new_vel, vel)
    age = torch.where(dead, 0.0, age)
    plife = torch.where(dead, new_life, plife)
    return torch.cat([pos, vel, age[:, None], plife[:, None]], dim=1)


class ParticleSystem:
    """Owns the device-resident state and declares the sim's compute node
    (particles.py:99-186). Per frame (SceneApp ``--particles``):

    1. ``sim_to(builder, dt)`` declares the compute node and exports the
       stepped state and the (P, 3) positions;
    2. ``context.request_output`` both; ``feedback(state, positions)`` keeps
       them for the next frame;
    3. the emitter's SceneObject draws instanced at ``positions`` (device
       offsets pass through the renderers untouched).

    The state starts on ``device`` in the shape and dtype of the fed-back
    tensors, so frame 0 and every later frame share one frame function."""

    def __init__(self, count: int, emitter=(0.0, 0.0, 2.0), *,
                 device: "torch.device | str", **sim_kwargs):
        self.count = int(count)
        self.emitter = np.asarray(emitter, np.float32)
        self.sim_kwargs = dict(sim_kwargs)
        self._tick = 0
        # Everything starts dead (age >= life), so frame 0 respawns staggered.
        init = np.zeros((self.count, _STATE_COLS), np.float32)
        init[:, 2] = -1e4  # far below the ground, unseen until respawned
        init[:, 6] = 1e3  # age
        init[:, 7] = np.linspace(0.01, 2.0, self.count)  # staggered deaths
        self._state = torch.from_numpy(init).to(device)
        self._positions = self._state[:, :3].clone()

    def __zenith_capture_key__(self):
        return ("particles", self.count, tuple(self.emitter.tolist()),
                tuple(sorted(self.sim_kwargs.items())))

    @property
    def positions(self) -> torch.Tensor:
        """(P, 3) device positions of the last completed step."""
        return self._positions

    def feedback(self, state: torch.Tensor, positions: torch.Tensor) -> None:
        self._state = state
        self._positions = positions
        # The hash salt advances once per completed frame here, so
        # frame_dynamics stays pure and update_dynamics followed by a
        # rebuild cannot advance it twice.
        self._tick += 1

    def frame_dynamics(self, dt: float) -> dict:
        """This frame's values (retained mode merges them too); pure, safe
        to call more than once a frame."""
        return {
            "psys.state": self._state,
            "psys.dt": np.float32(max(dt, 1e-4)),
            "psys.tick": np.float32(self._tick),
        }

    def sim_to(self, builder: RenderGraphBuilder, dt: float):
        """Declare the sim's compute node. Returns (state handle, positions
        handle), both exported; feed their values back with ``feedback``."""
        for name, value in self.frame_dynamics(dt).items():
            builder.set_dynamic(name, value)
        state_out = builder.create(BufferDesc.storage("psys.state.out",
                                                      (self.count, _STATE_COLS)))
        pos_out = builder.create(BufferDesc.storage("psys.pos.out", (self.count, 3)))
        node = builder.add_compute_node("psys.step")
        st_w = node.write(state_out)
        pos_w = node.write(pos_out)
        emitter = tuple(float(e) for e in self.emitter)
        kwargs = self.sim_kwargs

        def record(ctx):
            new_state = particle_step(ctx.dynamic("psys.state"), ctx.dynamic("psys.dt"),
                                      ctx.dynamic("psys.tick"), emitter, **kwargs)
            ctx.set(st_w, new_state)
            ctx.set(pos_w, new_state[:, 0:3])

        node.execute(record)
        builder.export(state_out)
        builder.export(pos_out)
        return state_out, pos_out

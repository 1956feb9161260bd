"""Synthetic geometric worlds + vectorized ray casting (port of
``lili_om_tpu/sim/world.py``). The worlds are built with numpy from the same
seeded draws as the JAX package, so both packages cast against the same
geometry."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class World(NamedTuple):
    plane_center: torch.Tensor  # (P,3)
    plane_normal: torch.Tensor  # (P,3) unit
    plane_u: torch.Tensor  # (P,3)
    plane_v: torch.Tensor  # (P,3)
    plane_half: torch.Tensor  # (P,2)
    cyl_base: torch.Tensor  # (C,3)
    cyl_axis: torch.Tensor  # (C,3)
    cyl_radius: torch.Tensor  # (C,)
    cyl_half_len: torch.Tensor  # (C,)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


class WorldBuilder:
    def __init__(self):
        self._planes = []
        self._cyls = []

    def add_plane(self, center, normal, u, half_u, half_v):
        n = _unit(normal)
        u = _unit(np.asarray(u) - np.dot(u, n) * n)
        v = np.cross(n, u)
        self._planes.append((np.asarray(center, np.float64), n, u, v, np.array([half_u, half_v])))
        return self

    def add_box_room(self, center, size):
        """Axis-aligned room interior: floor, ceiling, 4 walls."""
        cx, cy, cz = center
        sx, sy, sz = np.asarray(size) / 2.0
        self.add_plane((cx, cy, cz - sz), (0, 0, 1), (1, 0, 0), sx, sy)
        self.add_plane((cx, cy, cz + sz), (0, 0, -1), (1, 0, 0), sx, sy)
        self.add_plane((cx - sx, cy, cz), (1, 0, 0), (0, 1, 0), sy, sz)
        self.add_plane((cx + sx, cy, cz), (-1, 0, 0), (0, 1, 0), sy, sz)
        self.add_plane((cx, cy - sy, cz), (0, 1, 0), (1, 0, 0), sx, sz)
        self.add_plane((cx, cy + sy, cz), (0, -1, 0), (1, 0, 0), sx, sz)
        return self

    def add_pole(self, base, radius=0.15, height=4.0, axis=(0, 0, 1)):
        self._cyls.append((np.asarray(base, np.float64), _unit(axis), float(radius), height / 2.0))
        return self

    def build(self, dtype=torch.float32, device=None) -> World:
        if self._planes:
            pc, pn, pu, pv, ph = (np.stack(x) for x in zip(*self._planes))
        else:
            pc = pn = pu = pv = np.zeros((0, 3))
            ph = np.zeros((0, 2))
        if self._cyls:
            cb, ca, cr, cl = (np.stack(x) for x in zip(*self._cyls))
        else:
            cb = ca = np.zeros((0, 3))
            cr = cl = np.zeros((0,))
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype).to(device)
        return World(t(pc), t(pn), t(pu), t(pv), t(ph), t(cb), t(ca), t(cr), t(cl))


def make_room_world(size=(60.0, 40.0, 8.0), n_poles: int = 12, seed: int = 0,
                    interior_walls: bool = True, dtype=torch.float32, device=None) -> World:
    """A closed hall with interior partition walls and random poles."""
    rng = np.random.default_rng(seed)
    b = WorldBuilder().add_box_room((0.0, 0.0, size[2] / 2 - 1.5), size)
    if interior_walls:
        for _ in range(4):
            ang = rng.uniform(0, np.pi)
            c = rng.uniform(-0.3, 0.3, 3) * np.asarray(size)
            c[2] = size[2] / 2 - 1.5
            n = np.array([np.cos(ang), np.sin(ang), 0.0])
            u = np.array([-np.sin(ang), np.cos(ang), 0.0])
            b.add_plane(c, n, u, rng.uniform(3.0, 8.0), size[2] / 2)
    for _ in range(n_poles):
        base = rng.uniform(-0.4, 0.4, 3) * np.asarray(size)
        base[2] = 0.5
        b.add_pole(base, radius=rng.uniform(0.1, 0.3), height=rng.uniform(3.0, 6.0))
    return b.build(dtype=dtype, device=device)


def make_corridor_world(length: float = 120.0, width: float = 8.0, height: float = 5.0,
                        pole_spacing: float = 7.0, dtype=torch.float32, device=None) -> World:
    """Long corridor with poles along both walls: the straight-trajectory
    odometry scene. The box is flush (floor, walls and end caps meet), so
    edges come only from poles and plane junctions."""
    cx, hx = length / 2 - 10, length / 2 + 20
    b = WorldBuilder()
    b.add_plane((cx, 0, -1.5), (0, 0, 1), (1, 0, 0), hx, width / 2)
    b.add_plane((cx, 0, -1.5 + height), (0, 0, -1), (1, 0, 0), hx, width / 2)
    b.add_plane((cx, -width / 2, -1.5 + height / 2), (0, 1, 0), (1, 0, 0), hx, height / 2)
    b.add_plane((cx, width / 2, -1.5 + height / 2), (0, -1, 0), (1, 0, 0), hx, height / 2)
    b.add_plane((cx + hx, 0, -1.5 + height / 2), (-1, 0, 0), (0, 1, 0), width / 2, height / 2)
    b.add_plane((cx - hx, 0, -1.5 + height / 2), (1, 0, 0), (0, 1, 0), width / 2, height / 2)
    x = 0.0
    side = 1.0
    while x < length + 5:
        b.add_pole((x, side * (width / 2 - 0.8), -1.0), radius=0.15, height=4.0)
        side = -side
        x += pole_spacing
    return b.build(dtype=dtype, device=device)


def ray_cast(world: World, origins: torch.Tensor, dirs: torch.Tensor,
             min_range: float = 0.5, max_range: float = 200.0) -> torch.Tensor:
    """Cast rays against all primitives; masked min over hits. Returns the
    hit distance per ray, ``inf`` where nothing was hit."""
    inf = float("inf")
    world = World(*[w.to(origins.dtype) for w in world])  # promote, as JAX does
    # planes: s = n·(c−o) / n·d, bounded to the patch
    oc = world.plane_center[None, :, :] - origins[:, None, :]
    denom = torch.einsum("nd,pd->np", dirs, world.plane_normal)
    s_pl = torch.einsum("npd,pd->np", oc, world.plane_normal) / torch.where(
        torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
    hit = origins[:, None, :] + s_pl[..., None] * dirs[:, None, :] - world.plane_center[None, :, :]
    in_u = torch.abs(torch.einsum("npd,pd->np", hit, world.plane_u)) <= world.plane_half[None, :, 0]
    in_v = torch.abs(torch.einsum("npd,pd->np", hit, world.plane_v)) <= world.plane_half[None, :, 1]
    ok_pl = (s_pl > min_range) & (s_pl < max_range) & in_u & in_v & (torch.abs(denom) > 1e-9)
    s_pl = torch.where(ok_pl, s_pl, inf)

    # cylinders: |(o + s d − b) ⊥ w| = r
    ob = origins[:, None, :] - world.cyl_base[None, :, :]
    w = world.cyl_axis
    d_perp = dirs[:, None, :] - torch.einsum("nd,cd->nc", dirs, w)[..., None] * w[None, :, :]
    o_perp = ob - torch.einsum("ncd,cd->nc", ob, w)[..., None] * w[None, :, :]
    a = torch.sum(d_perp * d_perp, dim=-1)
    bq = 2.0 * torch.sum(d_perp * o_perp, dim=-1)
    c = torch.sum(o_perp * o_perp, dim=-1) - world.cyl_radius[None, :] ** 2
    disc = bq * bq - 4.0 * a * c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a < 1e-12, torch.full_like(a, 1e-12), a)
    s_cy = (-bq - sqrt_disc) / (2.0 * a_safe)
    z = torch.einsum("ncd,cd->nc", ob + s_cy[..., None] * dirs[:, None, :], w)
    ok_cy = ((disc > 0) & (s_cy > min_range) & (s_cy < max_range)
             & (torch.abs(z) <= world.cyl_half_len[None, :]) & (a > 1e-12))
    s_cy = torch.where(ok_cy, s_cy, inf)
    return torch.min(torch.cat([s_pl, s_cy], dim=1), dim=1).values

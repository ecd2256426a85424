"""Scene-level trace: two-level (instance → mesh) closest-hit / any-hit.

The replacement for ``traceRayEXT`` against a TLAS
(``src/shader.rgen:86,111``): rays are transformed into each instance's
object space by the inverse instance transform (what the driver's TLAS
traversal does in hardware) and tested against that mesh's geometry,
keeping the closest world-parameterized ``t`` across instances.

``static.traversal`` picks the walk, resolved once at scene build
(``accel.resolve_traversal``):

* ``"kernel"`` — the per-ray GPU kernel (``ops/bvh_kernel.py``), which
  runs the instance loop itself;
* ``"xla"`` — the packet walk (``ops/packet.py``), one ``lax.while_loop``
  per instance, the CPU path and the plain reference on the card;
* no BVH attached — brute force over every triangle.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from raytpu.device_scene import DeviceScene, SceneStatic
from raytpu.ops import vec3 as v3
from raytpu.ops.intersect import BIG_T, brute_anyhit, brute_closest


class HitWave(NamedTuple):
    """Shading-ready closest-hit result for a packet wave: the world-space
    unit shading normal (interpolated + instance inverse-transpose,
    ``src/shader.rchit:93-94``) and the per-lane material id, with the hit
    record beside them."""

    t: jnp.ndarray       # (P, K) float32, BIG_T on miss
    valid: jnp.ndarray   # (P, K) bool
    mat: jnp.ndarray     # (P, K) int32 material type of hit instance
    n: tuple             # Vec3 of (P, K): world-space unit shading normal
    inst: jnp.ndarray    # (P, K) int32 instance id, -1 on miss
    prim: jnp.ndarray    # (P, K) int32 global primitive id, -1 on miss
    u: jnp.ndarray
    v: jnp.ndarray

    @property
    def is_hit(self) -> jnp.ndarray:
        return self.valid


def _use_kernel(static: SceneStatic) -> bool:
    return static.has_bvh and static.traversal == "kernel"


def closest_hit_wave(
    scene: DeviceScene,
    static: SceneStatic,
    o,                  # Vec3 of (P, K): world-space origins (packet layout)
    d,                  # Vec3 of (P, K)
    tmin: float,
    tmax: jnp.ndarray,  # (P, K) or scalar
) -> HitWave:
    """Packet-layout closest hit over all instances (component-SoA:
    ``o``/``d`` are tuples of three (P, K) arrays, ``ops/vec3.py``)."""
    p, k = o[0].shape
    if _use_kernel(static):
        from raytpu.ops import bvh_kernel

        flat = tuple(x.reshape(-1) for x in (*o, *d))
        win = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (p, k))
        h = bvh_kernel.closest(scene, static, flat[:3], flat[3:], tmin,
                               win.reshape(-1), interpret=static.interpret)
        valid = h.slot >= 0
        prim = jnp.where(
            valid, jnp.take(scene.bvh_tri_prim, jnp.maximum(h.slot, 0)), -1)
        mat = jnp.where(
            valid, jnp.take(scene.materials, jnp.maximum(h.inst, 0)), 0)

        def pk(x):
            return x.reshape(p, k)

        return HitWave(
            t=pk(h.t), valid=pk(valid), mat=pk(mat),
            n=v3.normalize(tuple(pk(c) for c in h.n)),
            inst=pk(h.inst), prim=pk(prim), u=pk(h.u), v=pk(h.v),
        )

    zero = jnp.zeros((p, k), jnp.float32)
    best_t = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (p, k))
    best_valid = jnp.zeros((p, k), bool)
    best_mat = jnp.zeros((p, k), jnp.int32)
    best_n = (zero, zero, zero + 1.0)
    best_inst = jnp.full((p, k), -1, jnp.int32)
    best_prim = jnp.full((p, k), -1, jnp.int32)
    best_u = zero
    best_v = zero

    for inst_id, mesh_id in static.traversal_list:
        w2o_i = scene.w2o[inst_id]
        o_obj = v3.affine_rows(w2o_i, o)
        d_obj = v3.linear_rows(w2o_i, d)
        if static.has_bvh:
            from raytpu.ops.packet import packet_closest

            t, prim, u, v = packet_closest(
                scene, static, mesh_id, o_obj, d_obj, tmin, best_t
            )
        else:
            start, count = static.mesh_prim_ranges[mesh_id]
            t, prim, u, v = brute_closest(
                v3.to_array(o_obj).reshape(-1, 3),
                v3.to_array(d_obj).reshape(-1, 3),
                scene.tri_v0[start : start + count],
                scene.tri_e1[start : start + count],
                scene.tri_e2[start : start + count],
                tmin,
                best_t.reshape(-1),
            )
            t = t.reshape(p, k)
            prim = jnp.where(prim >= 0, prim + start, prim).reshape(p, k)
            u, v = u.reshape(p, k), v.reshape(p, k)
        found = prim >= 0
        n_obj = _normals_by_prim(scene, prim, u, v)

        # world normal via inverse-transpose (row-vector · W2O linear,
        # src/shader.rchit:94)
        n_world = v3.linear_cols(w2o_i, n_obj)

        better = found & (t < best_t)
        best_valid = best_valid | better
        best_mat = jnp.where(better, scene.materials[inst_id], best_mat)
        best_inst = jnp.where(better, jnp.int32(inst_id), best_inst)
        best_prim = jnp.where(better, prim, best_prim)
        best_n = v3.where(better, n_world, best_n)
        best_u = jnp.where(better, u, best_u)
        best_v = jnp.where(better, v, best_v)
        best_t = jnp.where(better, t, best_t)

    return HitWave(
        t=jnp.where(best_valid, best_t, BIG_T),
        valid=best_valid,
        mat=best_mat,
        n=v3.normalize(best_n),
        inst=best_inst,
        prim=best_prim,
        u=best_u,
        v=best_v,
    )


def _normals_by_prim(scene: DeviceScene, prim, u, v):
    """Barycentric normal interpolation via per-lane gathers from the
    prim-ordered tables."""
    p = jnp.maximum(prim, 0)
    w = 1.0 - u - v
    return tuple(
        w * jnp.take(scene.tri_n_soa[c], p, axis=0)
        + u * jnp.take(scene.tri_n_soa[3 + c], p, axis=0)
        + v * jnp.take(scene.tri_n_soa[6 + c], p, axis=0)
        for c in range(3)
    )


def any_hit_wave(
    scene: DeviceScene,
    static: SceneStatic,
    o,                  # Vec3 of (P, K)
    d,                  # Vec3 of (P, K)
    tmin: float,
    tmax: jnp.ndarray,  # (P, K)
) -> jnp.ndarray:
    """Packet-layout occlusion query over all instances (shadow rays,
    ``src/shader.rgen:111-112``)."""
    p, k = o[0].shape
    if _use_kernel(static):
        from raytpu.ops import bvh_kernel

        flat = tuple(x.reshape(-1) for x in (*o, *d))
        win = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (p, k))
        occ = bvh_kernel.anyhit(scene, static, flat[:3], flat[3:], tmin,
                                win.reshape(-1), interpret=static.interpret)
        return occ.reshape(p, k)

    occluded = jnp.zeros((p, k), bool)
    for inst_id, mesh_id in static.traversal_list:
        w2o_i = scene.w2o[inst_id]
        o_obj = v3.affine_rows(w2o_i, o)
        d_obj = v3.linear_rows(w2o_i, d)
        # already-occluded lanes get tmax=0 → trivially rejected everywhere
        lane_tmax = jnp.where(occluded, 0.0, tmax)
        if static.has_bvh:
            from raytpu.ops.packet import packet_anyhit

            occ = packet_anyhit(
                scene, static, mesh_id, o_obj, d_obj, tmin, lane_tmax
            )
        else:
            start, count = static.mesh_prim_ranges[mesh_id]
            occ = brute_anyhit(
                v3.to_array(o_obj).reshape(-1, 3),
                v3.to_array(d_obj).reshape(-1, 3),
                scene.tri_v0[start : start + count],
                scene.tri_e1[start : start + count],
                scene.tri_e2[start : start + count],
                tmin,
                lane_tmax.reshape(-1),
            ).reshape(p, k)
        occluded = occluded | occ
    return occluded

"""Vectorized stackless BVH traversal (the `traceRayEXT` compute kernel).

Software replacement for the ray-traversal hardware behind ``traceRayEXT``
(``src/shader.rgen:86,111``): a **threaded** (skip-link) BVH walked by the
whole ray wave in lock-step. Per-ray state is one node index; each
`lax.while_loop` iteration performs one node visit for every ray:

* gather the node record (AABB + leaf range + skip link) by node index;
* inner node: slab test → descend to ``i+1`` on hit, jump to ``miss[i]``
  otherwise — ordered by the builder's DFS layout;
* leaf node: test its ≤ ``LEAF_SIZE`` triangles (statically unrolled masked
  Möller–Trumbore), then jump to ``miss[i]``;
* terminated rays park at the sentinel (``node == end``) and the loop exits
  when every lane is parked.

Everything is gathers + elementwise math — no per-ray stacks, no
scatters, no dynamic shapes. The trip count is the longest walk in the
batch, so the renderer uses the packet walk (``ops/packet.py``) and the GPU
kernel (``ops/bvh_kernel.py``) instead; this per-ray version is the test
reference for the BVH builders.

Any-hit ("shadow") traversal additionally parks a lane the moment it finds
any intersection — the analog of
``gl_RayFlagsTerminateOnFirstHitEXT | SkipClosestHitShaderEXT``
(``src/shader.rgen:67``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from raytpu.device_scene import DeviceScene, SceneStatic
from raytpu.ops.intersect import (
    BIG_T,
    LEAF_UNROLL,
    moller_trumbore,
    ray_aabb,
    safe_inverse,
)

# triangles tested per leaf visit; must be ≥ the builder's leaf_size


def _leaf_intersect(
    scene: DeviceScene,
    tri_base: int,
    first: jnp.ndarray,   # (R,) leaf first-slot (mesh-local), valid when leaf
    count: jnp.ndarray,   # (R,)
    is_leaf: jnp.ndarray,  # (R,)
    o: jnp.ndarray,
    d: jnp.ndarray,
    tmin: float,
    best_t: jnp.ndarray,
    best_slot: jnp.ndarray,
    best_u: jnp.ndarray,
    best_v: jnp.ndarray,
):
    """Statically-unrolled masked triangle tests for one leaf visit."""
    for k in range(LEAF_UNROLL):
        valid = is_leaf & (k < count)
        slot = tri_base + jnp.maximum(first, 0) + k
        slot = jnp.minimum(slot, scene.bvh_tri_v0.shape[0] - 1)
        v0 = jnp.take(scene.bvh_tri_v0, slot, axis=0)
        e1 = jnp.take(scene.bvh_tri_e1, slot, axis=0)
        e2 = jnp.take(scene.bvh_tri_e2, slot, axis=0)
        t, u, v, hit = moller_trumbore(o, d, v0, e1, e2, tmin, best_t)
        hit = hit & valid
        best_slot = jnp.where(hit, slot, best_slot)
        best_u = jnp.where(hit, u, best_u)
        best_v = jnp.where(hit, v, best_v)
        best_t = jnp.where(hit, t, best_t)
    return best_t, best_slot, best_u, best_v


def bvh_closest(
    scene: DeviceScene,
    static: SceneStatic,
    mesh_id: int,
    o: jnp.ndarray,     # (R, 3) object-space origins
    d: jnp.ndarray,     # (R, 3) object-space directions (unnormalized ok)
    tmin: float,
    tmax: jnp.ndarray,  # (R,) current best world-t (doubles as the prune)
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closest hit against one mesh's threaded BVH.

    Returns (t, prim, u, v) with ``prim`` the GLOBAL primitive id (into the
    concatenated triangle arrays) or -1.
    """
    node_base, node_count = static.mesh_node_ranges[mesh_id]
    tri_base, _ = static.mesh_bvh_tri_ranges[mesh_id]
    end = node_base + node_count

    r = o.shape[0]
    inv_d = safe_inverse(d)
    tmax_r = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))

    # lanes with tmax ≤ tmin (inactive) park immediately
    node0 = jnp.where(tmax_r > tmin, jnp.int32(node_base), jnp.int32(end))

    def cond(state):
        node, _, _, _, _ = state
        return jnp.any(node != end)

    def body(state):
        node, best_t, best_slot, best_u, best_v = state
        n = jnp.minimum(node, end - 1)  # parked lanes gather a dummy node
        bmin = jnp.take(scene.bvh_aabb_min, n, axis=0)
        bmax = jnp.take(scene.bvh_aabb_max, n, axis=0)
        first = jnp.take(scene.bvh_tri_first, n, axis=0)
        count = jnp.take(scene.bvh_tri_count, n, axis=0)
        miss = jnp.take(scene.bvh_miss, n, axis=0) + node_base

        parked = node == end
        is_leaf = (first >= 0) & ~parked

        best_t, best_slot, best_u, best_v = _leaf_intersect(
            scene, tri_base, first, count, is_leaf,
            o, d, tmin, best_t, best_slot, best_u, best_v,
        )

        box_hit = ray_aabb(
            o, inv_d, bmin, bmax, jnp.full((r,), tmin, jnp.float32), best_t
        )
        nxt = jnp.where(is_leaf | ~box_hit, miss, node + 1)
        node = jnp.where(parked, end, nxt)
        return node, best_t, best_slot, best_u, best_v

    init = (
        node0,
        tmax_r,
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    _, best_t, best_slot, best_u, best_v = jax.lax.while_loop(cond, body, init)

    hit = best_slot >= 0
    prim = jnp.where(
        hit,
        jnp.take(scene.bvh_tri_prim, jnp.maximum(best_slot, 0), axis=0),
        jnp.int32(-1),
    )
    return jnp.where(hit, best_t, BIG_T), prim, best_u, best_v


def bvh_anyhit(
    scene: DeviceScene,
    static: SceneStatic,
    mesh_id: int,
    o: jnp.ndarray,
    d: jnp.ndarray,
    tmin: float,
    tmax: jnp.ndarray,  # (R,)
) -> jnp.ndarray:
    """Occlusion traversal: terminate a lane on its first accepted hit."""
    node_base, node_count = static.mesh_node_ranges[mesh_id]
    tri_base, _ = static.mesh_bvh_tri_ranges[mesh_id]
    end = node_base + node_count

    r = o.shape[0]
    inv_d = safe_inverse(d)
    tmax_r = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    node0 = jnp.where(tmax_r > tmin, jnp.int32(node_base), jnp.int32(end))

    def cond(state):
        node, _ = state
        return jnp.any(node != end)

    def body(state):
        node, occluded = state
        n = jnp.minimum(node, end - 1)
        bmin = jnp.take(scene.bvh_aabb_min, n, axis=0)
        bmax = jnp.take(scene.bvh_aabb_max, n, axis=0)
        first = jnp.take(scene.bvh_tri_first, n, axis=0)
        count = jnp.take(scene.bvh_tri_count, n, axis=0)
        miss = jnp.take(scene.bvh_miss, n, axis=0) + node_base

        parked = node == end
        is_leaf = (first >= 0) & ~parked

        found = jnp.zeros((r,), bool)
        for k in range(LEAF_UNROLL):
            valid = is_leaf & (k < count)
            slot = tri_base + jnp.maximum(first, 0) + k
            slot = jnp.minimum(slot, scene.bvh_tri_v0.shape[0] - 1)
            v0 = jnp.take(scene.bvh_tri_v0, slot, axis=0)
            e1 = jnp.take(scene.bvh_tri_e1, slot, axis=0)
            e2 = jnp.take(scene.bvh_tri_e2, slot, axis=0)
            _, _, _, hit = moller_trumbore(o, d, v0, e1, e2, tmin, tmax_r)
            found = found | (hit & valid)
        occluded = occluded | found

        box_hit = ray_aabb(
            o, inv_d, bmin, bmax, jnp.full((r,), tmin, jnp.float32), tmax_r
        )
        nxt = jnp.where(is_leaf | ~box_hit, miss, node + 1)
        node = jnp.where(parked | occluded, end, nxt)
        return node, occluded

    _, occluded = jax.lax.while_loop(
        cond, body, (node0, jnp.zeros((r,), bool))
    )
    return occluded

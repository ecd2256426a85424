"""Packet (consensus) BVH traversal — XLA fallback path (component-SoA).

Rays are grouped into spatially-coherent packets (pixel tiles); each
*packet* — not each ray — carries one node pointer into the threaded
(skip-link) BVH, so node fetch is a tiny (P,)-row gather and all tests are
dense (P, K) elementwise ops with **no per-ray gathers** and no (…, 3)-minor-axis
arrays (see ``ops/vec3.py`` for the layout rule).

This is the plain XLA walk: the traversal path on the CPU, and the
reference the GPU kernel (``ops/bvh_kernel.py``) is compared with on the
card. Per-lane correctness is exact: packets share only the traversal ORDER
(conservative — a packet may visit nodes some lanes don't need, never the
reverse).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from raytpu.device_scene import DeviceScene, SceneStatic
from raytpu.ops.intersect import BIG_T, LEAF_UNROLL



def _inv_dir(d):
    return tuple(
        jnp.where(x != 0.0, 1.0 / x, jnp.where(x >= 0, jnp.inf, -jnp.inf))
        for x in d
    )


def _gather_node(scene, n):
    """Per-packet node records: (P,) gathers — small."""
    bmin = [jnp.take(scene.bvh_aabb_min[:, c], n, axis=0) for c in range(3)]
    bmax = [jnp.take(scene.bvh_aabb_max[:, c], n, axis=0) for c in range(3)]
    first = jnp.take(scene.bvh_tri_first, n, axis=0)
    count = jnp.take(scene.bvh_tri_count, n, axis=0)
    miss = jnp.take(scene.bvh_miss, n, axis=0)
    return bmin, bmax, first, count, miss


def _slab_packet(o, inv_d, bmin, bmax, tmin, tfar_cap):
    """(P,K) slab test against each packet's own node (components are (P,)
    broadcast against (P,K))."""
    tns, tfs = [], []
    for c in range(3):
        lo = (bmin[c][:, None] - o[c]) * inv_d[c]
        hi = (bmax[c][:, None] - o[c]) * inv_d[c]
        tns.append(jnp.minimum(lo, hi))
        tfs.append(jnp.maximum(lo, hi))
    t_near = jnp.maximum(jnp.maximum(tns[0], tns[1]), jnp.maximum(tns[2], tmin))
    t_far = jnp.minimum(jnp.minimum(tfs[0], tfs[1]), jnp.minimum(tfs[2], tfar_cap))
    return t_near <= t_far


def _mt_packet(scene, tri_base, slot, o, d, tmin, best_t):
    """MT of one triangle slot per packet ((P,) gathers broadcast to (P,K))."""
    g = lambda table: jnp.take(table, slot, axis=0)[:, None]  # noqa: E731
    v0 = [g(scene.bvh_tri_v0[:, c]) for c in range(3)]
    e1 = [g(scene.bvh_tri_e1[:, c]) for c in range(3)]
    e2 = [g(scene.bvh_tri_e2[:, c]) for c in range(3)]
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)
    tvx = o[0] - v0[0]
    tvy = o[1] - v0[1]
    tvz = o[2] - v0[2]
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1[2] - tvz * e1[1]
    qy = tvz * e1[0] - tvx * e1[2]
    qz = tvx * e1[1] - tvy * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    hit = (
        (jnp.abs(det) > 1e-9)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < best_t)
    )
    return t, u, v, hit


def packet_closest(
    scene: DeviceScene,
    static: SceneStatic,
    mesh_id: int,
    o,                  # Vec3 of (P, K): object-space origins
    d,                  # Vec3 of (P, K)
    tmin: float,
    tmax: jnp.ndarray,  # (P, K)
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closest hit for packets. Returns (t, prim, u, v) of shape (P, K);
    ``prim`` is the GLOBAL primitive id or -1."""
    node_base, node_count = static.mesh_node_ranges[mesh_id]
    tri_base, _ = static.mesh_bvh_tri_ranges[mesh_id]
    end = node_base + node_count

    p, k = o[0].shape
    inv_d = _inv_dir(d)
    tmax_pk = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (p, k))

    node0 = jnp.where(
        jnp.any(tmax_pk > tmin, axis=1), jnp.int32(node_base), jnp.int32(end)
    )

    def cond(state):
        return jnp.any(state[0] != end)

    def body(state):
        node, best_t, best_slot, best_u, best_v = state
        n = jnp.minimum(node, end - 1)
        bmin, bmax, first, count, miss = _gather_node(scene, n)
        miss = miss + node_base
        parked = node == end
        is_leaf = (first >= 0) & ~parked

        for kk in range(LEAF_UNROLL):
            slot = tri_base + jnp.maximum(first, 0) + kk
            slot = jnp.minimum(slot, scene.bvh_tri_v0.shape[0] - 1)
            t, u, v, hit = _mt_packet(scene, tri_base, slot, o, d, tmin, best_t)
            hit = hit & (is_leaf & (kk < count))[:, None]
            best_slot = jnp.where(hit, slot[:, None], best_slot)
            best_u = jnp.where(hit, u, best_u)
            best_v = jnp.where(hit, v, best_v)
            best_t = jnp.where(hit, t, best_t)

        box_hit = _slab_packet(o, inv_d, bmin, bmax, tmin, best_t)
        any_box = jnp.any(box_hit, axis=1)
        nxt = jnp.where(is_leaf | ~any_box, miss, node + 1)
        node = jnp.where(parked, end, nxt)
        return node, best_t, best_slot, best_u, best_v

    init = (
        node0,
        tmax_pk,
        jnp.full((p, k), -1, jnp.int32),
        jnp.zeros((p, k), jnp.float32),
        jnp.zeros((p, k), jnp.float32),
    )
    _, best_t, best_slot, best_u, best_v = jax.lax.while_loop(cond, body, init)

    hit = best_slot >= 0
    prim = jnp.where(
        hit,
        jnp.take(scene.bvh_tri_prim, jnp.maximum(best_slot, 0), axis=0),
        jnp.int32(-1),
    )
    return jnp.where(hit, best_t, jnp.float32(BIG_T)), prim, best_u, best_v


def packet_anyhit(
    scene: DeviceScene,
    static: SceneStatic,
    mesh_id: int,
    o,                  # Vec3 of (P, K)
    d,
    tmin: float,
    tmax: jnp.ndarray,  # (P, K)
) -> jnp.ndarray:
    """Occlusion for packets: a packet parks when every live lane is
    occluded (or was never live)."""
    node_base, node_count = static.mesh_node_ranges[mesh_id]
    tri_base, _ = static.mesh_bvh_tri_ranges[mesh_id]
    end = node_base + node_count

    p, k = o[0].shape
    inv_d = _inv_dir(d)
    tmax_pk = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (p, k))
    live0 = tmax_pk > tmin
    node0 = jnp.where(jnp.any(live0, axis=1), jnp.int32(node_base), jnp.int32(end))

    def cond(state):
        return jnp.any(state[0] != end)

    def body(state):
        node, occluded = state
        n = jnp.minimum(node, end - 1)
        bmin, bmax, first, count, miss = _gather_node(scene, n)
        miss = miss + node_base
        parked = node == end
        is_leaf = (first >= 0) & ~parked

        for kk in range(LEAF_UNROLL):
            slot = tri_base + jnp.maximum(first, 0) + kk
            slot = jnp.minimum(slot, scene.bvh_tri_v0.shape[0] - 1)
            _, _, _, hit = _mt_packet(scene, tri_base, slot, o, d, tmin, tmax_pk)
            occluded = occluded | (hit & (is_leaf & (kk < count))[:, None])

        pending = live0 & ~occluded
        pend_t = jnp.where(pending, tmax_pk, 0.0)
        box_hit = _slab_packet(o, inv_d, bmin, bmax, tmin, pend_t)
        any_box = jnp.any(box_hit, axis=1)
        all_done = ~jnp.any(pending, axis=1)

        nxt = jnp.where(is_leaf | ~any_box, miss, node + 1)
        node = jnp.where(parked | all_done, end, nxt)
        return node, occluded

    _, occluded = jax.lax.while_loop(
        cond, body, (node0, jnp.zeros((p, k), bool))
    )
    return occluded

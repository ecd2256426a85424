"""Ray–primitive intersection ops (vectorized).

Software replacement for the fixed-function traversal/intersection hardware
invoked by ``traceRayEXT`` (``src/shader.rgen:86,111``). Everything here is
batched over rays: no per-ray Python control flow, no dynamic shapes.

Semantics:

* Möller–Trumbore, double-sided (the reference disables facing culling per
  instance via ``VK_GEOMETRY_INSTANCE_TRIANGLE_FACING_CULL_DISABLE_BIT_KHR``,
  ``src/main.cpp:538-551``), hit iff ``u ≥ 0 ∧ v ≥ 0 ∧ u+v ≤ 1`` and
  ``tmin < t < tmax`` (the open interval matches Vulkan's [tmin, tmax) with
  the reference's tmin=0.001 / tmax=10000, ``src/shader.rgen:87``);
* ray directions need **not** be normalized: object-space traversal
  transforms a world ray by the inverse instance transform without
  renormalizing, so ``t`` stays parameterized in world units (the same trick
  the Vulkan driver uses for TLAS instancing);
* barycentric convention matches ``hitAttributeEXT vec2 hitCoordinate``:
  weights ``(1-u-v, u, v)`` for corners (A, B, C) (``src/shader.rchit:66-67``).
"""

from __future__ import annotations

import os

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

DET_EPS = 1e-9
# Sentinel "no hit" distance. A PYTHON float on purpose: Pallas kernels that
# close over a jnp scalar would capture it as a constant operand ("captures
# constants [f32[]]" error); python floats weakly type to f32 everywhere.
BIG_T = 3.0e38
# Max triangles tested per BVH leaf; the XLA walks unroll exactly this many
# intersection tests per leaf visit, and builders must not emit larger
# leaves (enforced in raytpu/accel/__init__.py). RAYTPU_LEAF_SIZE sets BOTH
# this unroll and RenderConfig.leaf_size's default. Capped at 15 — the GPU
# kernel's node record keeps the leaf count in 4 bits (ops/bvh_kernel.py).
#
# Default 12: chosen by a leaf-size sweep before the move to the GPU and not
# re-measured there (a sweep is queued in ROADMAP.md).
LEAF_UNROLL = int(os.environ.get("RAYTPU_LEAF_SIZE", "12"))
assert 1 <= LEAF_UNROLL <= 15, "RAYTPU_LEAF_SIZE must be in [1, 15]"


class Hit(NamedTuple):
    """Closest-hit record for a batch of rays (payload analog,
    ``src/shader.rgen:6-17``). ``prim == -1`` encodes a miss, mirroring the
    reference's ``objectIndex = -1`` sentinel (``src/shader.rmiss:11``)."""

    t: jnp.ndarray     # (R,) float32, BIG_T on miss
    prim: jnp.ndarray  # (R,) int32 global primitive index, -1 on miss
    inst: jnp.ndarray  # (R,) int32 instance index, -1 on miss
    u: jnp.ndarray     # (R,) float32 barycentric
    v: jnp.ndarray     # (R,) float32 barycentric

    @property
    def is_hit(self) -> jnp.ndarray:
        return self.prim >= 0


def moller_trumbore(
    origin: jnp.ndarray,  # (..., 3)
    dirn: jnp.ndarray,    # (..., 3)
    v0: jnp.ndarray,      # (..., 3) triangle corner A
    e1: jnp.ndarray,      # (..., 3) B - A
    e2: jnp.ndarray,      # (..., 3) C - A
    tmin: float,
    tmax: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Double-sided Möller–Trumbore. Broadcasts over leading dims.

    Returns ``(t, u, v, hit)``; ``t`` is BIG_T where ``hit`` is False.
    """
    pvec = jnp.cross(dirn, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > DET_EPS, 1.0 / det, 0.0)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(dirn * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    return jnp.where(hit, t, BIG_T), u, v, hit


def ray_aabb(
    origin: jnp.ndarray,   # (..., 3)
    inv_dir: jnp.ndarray,  # (..., 3) precomputed 1/d (±inf for zero comps)
    box_min: jnp.ndarray,  # (..., 3)
    box_max: jnp.ndarray,  # (..., 3)
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
) -> jnp.ndarray:
    """Slab test: does the ray hit the AABB within (tmin, tmax)?

    Uses the min/max formulation that stays correct for inverted slabs and
    treats NaNs from 0·inf as non-constraining (the standard robust variant).
    """
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    # 0·inf NaNs (origin component exactly on a slab plane with a zero
    # direction component) must not constrain: the ray lies in the slab,
    # so that axis contributes (-inf, +inf).
    # The packet walk (ops/packet.py) propagates that NaN instead (node
    # skipped), so on such measure-zero rays the walks may disagree.
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    lo = jnp.where(jnp.isnan(lo), -jnp.inf, lo)
    hi = jnp.where(jnp.isnan(hi), jnp.inf, hi)
    t_near = jnp.max(jnp.maximum(lo, tmin[..., None]), axis=-1)
    t_far = jnp.minimum(jnp.min(hi, axis=-1), tmax)
    return t_near <= t_far


def safe_inverse(d: jnp.ndarray) -> jnp.ndarray:
    """1/d with ±inf for zero components (slab-test convention)."""
    return jnp.where(d != 0.0, 1.0 / d, jnp.where(d >= 0, jnp.inf, -jnp.inf))


# ---------------------------------------------------------------------------
# brute-force tracers (no BVH): the correctness oracle and the fast path for
# tiny meshes (cube = 12 triangles). Scans triangle blocks to bound memory.
# ---------------------------------------------------------------------------

def _pad_tris(v0, e1, e2, block: int):
    t = v0.shape[0]
    pad = (-t) % block
    if pad:
        # degenerate padding triangles (e1 = e2 = 0) can never be hit
        v0 = jnp.concatenate([v0, jnp.zeros((pad, 3), v0.dtype)], axis=0)
        e1 = jnp.concatenate([e1, jnp.zeros((pad, 3), e1.dtype)], axis=0)
        e2 = jnp.concatenate([e2, jnp.zeros((pad, 3), e2.dtype)], axis=0)
    return v0, e1, e2


def brute_closest(
    origin: jnp.ndarray,  # (R, 3)
    dirn: jnp.ndarray,    # (R, 3)
    v0: jnp.ndarray,      # (T, 3)
    e1: jnp.ndarray,
    e2: jnp.ndarray,
    tmin: float,
    tmax: jnp.ndarray,    # (R,) or scalar
    block: int = 512,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All-pairs closest hit, scanning triangle blocks.

    Returns (t, prim, u, v) with prim == -1 on miss. ``prim`` indexes into
    the v0/e1/e2 arrays passed in (caller rebases to global ids).
    """
    r = origin.shape[0]
    t_count = v0.shape[0]
    block = min(block, max(t_count, 1))
    v0p, e1p, e2p = _pad_tris(v0, e1, e2, block)
    n_blocks = v0p.shape[0] // block

    tmax_r = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))

    def body(carry, blk):
        best_t, best_prim, best_u, best_v = carry
        bv0, be1, be2, base = blk
        # (R, B) broadcast
        t, u, v, hit = moller_trumbore(
            origin[:, None, :],
            dirn[:, None, :],
            bv0[None, :, :],
            be1[None, :, :],
            be2[None, :, :],
            tmin,
            best_t[:, None],  # prune against current best (≤ tmax by init)
        )
        blk_arg = jnp.argmin(t, axis=1)
        blk_t = jnp.take_along_axis(t, blk_arg[:, None], axis=1)[:, 0]
        blk_u = jnp.take_along_axis(u, blk_arg[:, None], axis=1)[:, 0]
        blk_v = jnp.take_along_axis(v, blk_arg[:, None], axis=1)[:, 0]
        better = blk_t < best_t
        best_prim = jnp.where(better, base + blk_arg.astype(jnp.int32), best_prim)
        best_u = jnp.where(better, blk_u, best_u)
        best_v = jnp.where(better, blk_v, best_v)
        best_t = jnp.where(better, blk_t, best_t)
        return (best_t, best_prim, best_u, best_v), None

    init = (
        tmax_r,
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
    )
    blocks = (
        v0p.reshape(n_blocks, block, 3),
        e1p.reshape(n_blocks, block, 3),
        e2p.reshape(n_blocks, block, 3),
        jnp.arange(n_blocks, dtype=jnp.int32) * block,
    )
    (best_t, best_prim, best_u, best_v), _ = jax.lax.scan(body, init, blocks)
    best_t = jnp.where(best_prim >= 0, best_t, BIG_T)
    return best_t, best_prim, best_u, best_v


def brute_anyhit(
    origin: jnp.ndarray,
    dirn: jnp.ndarray,
    v0: jnp.ndarray,
    e1: jnp.ndarray,
    e2: jnp.ndarray,
    tmin: float,
    tmax: jnp.ndarray,
    block: int = 512,
) -> jnp.ndarray:
    """Occlusion query: any hit in (tmin, tmax)? The analog of the shadow
    ray flags ``TerminateOnFirstHit | SkipClosestHitShader``
    (``src/shader.rgen:67,111-112``)."""
    r = origin.shape[0]
    t_count = v0.shape[0]
    block = min(block, max(t_count, 1))
    v0p, e1p, e2p = _pad_tris(v0, e1, e2, block)
    n_blocks = v0p.shape[0] // block
    tmax_r = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))

    def body(occluded, blk):
        bv0, be1, be2 = blk
        _, _, _, hit = moller_trumbore(
            origin[:, None, :],
            dirn[:, None, :],
            bv0[None, :, :],
            be1[None, :, :],
            be2[None, :, :],
            tmin,
            tmax_r[:, None],
        )
        return occluded | jnp.any(hit, axis=1), None

    blocks = (
        v0p.reshape(n_blocks, block, 3),
        e1p.reshape(n_blocks, block, 3),
        e2p.reshape(n_blocks, block, 3),
    )
    occluded, _ = jax.lax.scan(body, jnp.zeros((r,), bool), blocks)
    return occluded

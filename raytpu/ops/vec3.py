"""Component-SoA 3-vector math.

Layout rule: an array whose minor axis is 3 wastes most of each vector
tile, and any op that changes such a layout (transpose, component slice
feeding a kernel) materializes a copy of a frame's rays. The wave path
therefore represents every 3-vector as a **tuple of three full-width
arrays** (x, y, z), contiguous per component, with all geometry math
written componentwise — the layout the GPU traversal kernel also reads.

A ``Vec3`` is just ``tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]`` — plain
pytrees, no wrapper class, so they pass through ``lax`` control flow
untouched.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

Vec3 = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]


def vec3(x, y, z) -> Vec3:
    return (x, y, z)


def splat(v, like) -> Vec3:
    """Broadcast a length-3 constant against a reference array."""
    return tuple(jnp.full_like(like, float(c)) for c in v)


def from_array(a: jnp.ndarray) -> Vec3:
    """(..., 3) → components. A relayout — use only at boundaries."""
    return (a[..., 0], a[..., 1], a[..., 2])


def to_array(v: Vec3) -> jnp.ndarray:
    """Components → (..., 3). A relayout — use only at boundaries."""
    return jnp.stack(v, axis=-1)


def add(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale(s, a: Vec3) -> Vec3:
    return (s * a[0], s * a[1], s * a[2])


def mul(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def neg(a: Vec3) -> Vec3:
    return (-a[0], -a[1], -a[2])


def dot(a: Vec3, b: Vec3) -> jnp.ndarray:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: Vec3, b: Vec3) -> Vec3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def norm(a: Vec3) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a: Vec3, eps: float = 1e-30) -> Vec3:
    inv = 1.0 / jnp.maximum(norm(a), eps)
    return scale(inv, a)


def where(mask: jnp.ndarray, a: Vec3, b: Vec3) -> Vec3:
    return (
        jnp.where(mask, a[0], b[0]),
        jnp.where(mask, a[1], b[1]),
        jnp.where(mask, a[2], b[2]),
    )


def affine_rows(m: jnp.ndarray, p: Vec3) -> Vec3:
    """Apply a (3, 4) affine (point transform): rows of ``m`` are scalar
    coefficients, so this is 9 scalar·vector FMAs + translation."""
    return (
        m[0, 0] * p[0] + m[0, 1] * p[1] + m[0, 2] * p[2] + m[0, 3],
        m[1, 0] * p[0] + m[1, 1] * p[1] + m[1, 2] * p[2] + m[1, 3],
        m[2, 0] * p[0] + m[2, 1] * p[1] + m[2, 2] * p[2] + m[2, 3],
    )


def linear_rows(m: jnp.ndarray, v: Vec3) -> Vec3:
    """Linear part only (direction transform)."""
    return (
        m[0, 0] * v[0] + m[0, 1] * v[1] + m[0, 2] * v[2],
        m[1, 0] * v[0] + m[1, 1] * v[1] + m[1, 2] * v[2],
        m[2, 0] * v[0] + m[2, 1] * v[1] + m[2, 2] * v[2],
    )


def linear_cols(m: jnp.ndarray, v: Vec3) -> Vec3:
    """Row-vector × matrix: ``v · M`` (the inverse-transpose normal
    transform of ``src/shader.rchit:94`` when M = world→object linear)."""
    return (
        m[0, 0] * v[0] + m[1, 0] * v[1] + m[2, 0] * v[2],
        m[0, 1] * v[0] + m[1, 1] * v[1] + m[2, 1] * v[2],
        m[0, 2] * v[0] + m[1, 2] * v[1] + m[2, 2] * v[2],
    )

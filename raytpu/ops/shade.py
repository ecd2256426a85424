"""Material shading math: diffuse (Blinn–Phong), mirror, refractive.

Elementwise ray-batch translations of the raygen shader's material branches
(``src/shader.rgen:97-177``). All functions are mask-free — the integrator
applies material masks via ``jnp.where`` so every lane computes every branch
(the standard SIMD Whitted formulation; branches are cheap elementwise
math, only traversal is expensive).

Faithfully reproduced quirks (these ARE the reference semantics):

* distance attenuation is computed but **unused** (``src/shader.rgen:123``)
  — we do not apply it;
* the Blinn–Phong contribution is scaled by ``0.9^sample_index`` — the
  *sample* index, not the bounce index (``src/shader.rgen:128``);
* IOR fixed at 1.52, specular exponent 100, constants kd/ka/ks/Iamb from
  ``src/shader.rgen:51-55``;
* refraction flips the normal when exiting (``ndoti > 0``) and uses
  ``ratio = exiting ? 1.52 : 1/1.52`` (``src/shader.rgen:143-151``);
* total internal reflection (``k < 0``) reflects about the (possibly
  flipped) normal with a ``+0.01·n`` origin offset; refraction offsets by
  ``−0.01·n`` (``src/shader.rgen:154-165``).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from raytpu.config import (
    AMBIENT_COEFF,
    AMBIENT_INTENSITY,
    DIFFUSE_COEFF,
    HIT_EPSILON,
    INDEX_OF_REFRACTION,
    SPECULAR_COEFF,
    SPECULAR_EXPONENT,
)


def ambient_color(dtype=jnp.float32) -> jnp.ndarray:
    """Initial per-sample color ``Iamb * ka`` (``src/shader.rgen:81``)."""
    return jnp.asarray(AMBIENT_INTENSITY, dtype) * jnp.asarray(AMBIENT_COEFF, dtype)


# ---------------------------------------------------------------------------
# component-SoA variants (the wave path; see ops/vec3.py for why)
# ---------------------------------------------------------------------------

from raytpu.ops import vec3 as v3  # noqa: E402


def ambient_tuple():
    return tuple(
        float(a) * float(k) for a, k in zip(AMBIENT_INTENSITY, AMBIENT_COEFF)
    )


def reflect_soa(d, n):
    """``d − 2·(d·n)·n`` componentwise."""
    k = 2.0 * v3.dot(d, n)
    return v3.sub(d, v3.scale(k, n))


def blinn_phong_soa(n, l, view, light_intensity):
    """Componentwise Blinn–Phong (``src/shader.rgen:116-126``). Returns a
    Vec3 contribution; caller applies decay + shadow mask."""
    h = v3.normalize(v3.add(l, view))
    ndotl = jnp.maximum(v3.dot(n, l), 0.0)
    ndoth = jnp.maximum(v3.dot(n, h), 0.0)
    spec = ndoth ** SPECULAR_EXPONENT
    return tuple(
        light_intensity * (kd_c * ndotl + ks_c * spec)
        for kd_c, ks_c in zip(DIFFUSE_COEFF, SPECULAR_COEFF)
    )


def mirror_bounce_soa(d, n, hit_pos):
    """Mirror branch (``src/shader.rgen:132-138``)."""
    new_o = v3.add(hit_pos, v3.scale(HIT_EPSILON, n))
    return new_o, reflect_soa(d, n)


def refract_bounce_soa(d, n, hit_pos):
    """Refractive branch with Snell + TIR (``src/shader.rgen:139-177``)."""
    ndoti = v3.dot(d, n)
    outwards = ndoti > 0.0
    n_f = v3.where(outwards, v3.neg(n), n)
    ndoti_f = jnp.where(outwards, -ndoti, ndoti)
    ratio = jnp.where(outwards, INDEX_OF_REFRACTION, 1.0 / INDEX_OF_REFRACTION)
    k = 1.0 - ratio * ratio * (1.0 - ndoti_f * ndoti_f)
    tir = k < 0.0

    d_tir = reflect_soa(d, n_f)
    o_tir = v3.add(hit_pos, v3.scale(HIT_EPSILON, n_f))

    coeff = ratio * ndoti_f + jnp.sqrt(jnp.maximum(k, 0.0))
    r = v3.normalize(v3.sub(v3.scale(ratio, d), v3.scale(coeff, n_f)))
    o_ref = v3.sub(hit_pos, v3.scale(HIT_EPSILON, n_f))

    return v3.where(tir, o_tir, o_ref), v3.where(tir, d_tir, r)


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """GLSL ``reflect``: ``d − 2·(d·n)·n`` (``src/shader.rgen:137,157``)."""
    return d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n


def blinn_phong(
    n: jnp.ndarray,          # (R, 3) shading normal
    l: jnp.ndarray,          # (R, 3) unit direction to light
    view: jnp.ndarray,       # (R, 3) unit direction to viewer (-ray dir)
    light_intensity: jnp.ndarray,  # scalar
) -> jnp.ndarray:
    """``lightIntensity * (kd·max(0,N·L) + ks·max(0,N·H)^100)``
    (``src/shader.rgen:116-126``). The caller applies the ``0.9^sample``
    decay and the shadow mask."""
    h = l + view
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-30)
    ndotl = jnp.maximum(jnp.sum(n * l, axis=-1), 0.0)
    ndoth = jnp.maximum(jnp.sum(n * h, axis=-1), 0.0)
    kd = jnp.asarray(DIFFUSE_COEFF, n.dtype)
    ks = jnp.asarray(SPECULAR_COEFF, n.dtype)
    diffuse = kd * ndotl[..., None]
    specular = ks * (ndoth ** SPECULAR_EXPONENT)[..., None]
    return light_intensity * (diffuse + specular)


def mirror_bounce(
    d: jnp.ndarray, n: jnp.ndarray, hit_pos: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mirror branch (``src/shader.rgen:132-138``): new (origin, direction)."""
    new_o = hit_pos + HIT_EPSILON * n
    new_d = reflect(d, n)
    return new_o, new_d


def refract_bounce(
    d: jnp.ndarray, n: jnp.ndarray, hit_pos: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Refractive branch with Snell's law + TIR (``src/shader.rgen:139-177``)."""
    ndoti = jnp.sum(d * n, axis=-1, keepdims=True)
    outwards = ndoti > 0.0
    n_f = jnp.where(outwards, -n, n)
    ndoti_f = jnp.where(outwards, -ndoti, ndoti)
    ratio = jnp.where(
        outwards,
        jnp.asarray(INDEX_OF_REFRACTION, d.dtype),
        jnp.asarray(1.0 / INDEX_OF_REFRACTION, d.dtype),
    )
    k = 1.0 - ratio * ratio * (1.0 - ndoti_f * ndoti_f)
    tir = k < 0.0

    # TIR: reflect about flipped normal, offset +eps·n_f
    d_tir = reflect(d, n_f)
    o_tir = hit_pos + HIT_EPSILON * n_f

    # refract: R = ratio·d − (ratio·ndoti + √k)·n, then normalize; −eps·n_f
    sqrt_k = jnp.sqrt(jnp.maximum(k, 0.0))
    r = ratio * d - (ratio * ndoti_f + sqrt_k) * n_f
    r = r / jnp.maximum(jnp.linalg.norm(r, axis=-1, keepdims=True), 1e-30)
    o_ref = hit_pos - HIT_EPSILON * n_f

    new_d = jnp.where(tir, d_tir, r)
    new_o = jnp.where(tir, o_tir, o_ref)
    return new_o, new_d

"""Cubemap skybox sampling.

Software replacement for ``texture(samplerCube, dir)`` — the reference
binds a 6-layer cube image with a LINEAR, CLAMP_TO_EDGE sampler
(``src/main.cpp:2376-2412``) and samples it on ray miss with the direction
``(d.x, d.y, -d.z)`` (``src/shader.rgen:92``; the z-flip is applied by the
*caller*, i.e. the integrator, to keep this module a faithful GL/Vulkan cube
sampler).

Face selection and (s, t) derivation follow the Vulkan/GL cube-map rules
(major-axis table), with faces indexed +X, −X, +Y, −Y, +Z, −Z — the layer
order the reference uploads (``src/main.cpp:2064-2079``). Bilinear filtering
uses half-texel centers and clamp-to-edge addressing.
"""

from __future__ import annotations

import jax.numpy as jnp


def face_st(x, y, z):
    """GL cube-map major-axis table on per-component arrays.

    Maps direction components (any matching shapes) → ``(face, s, t)``:

    ====  ========  ========
    face  sc        tc
    ====  ========  ========
    +X    -z        -y
    -X    +z        -y
    +Y    +x        +z
    -Y    +x        -z
    +Z    +x        -y
    -Z    -x        -y
    ====  ========  ========

    ``s = (sc/|ma| + 1)/2``, ``t = (tc/|ma| + 1)/2``. The single source of
    the face math shared by all sampler variants below.
    """
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    # else Z

    face = jnp.where(
        is_x,
        jnp.where(x >= 0, 0, 1),
        jnp.where(is_y, jnp.where(y >= 0, 2, 3), jnp.where(z >= 0, 4, 5)),
    ).astype(jnp.int32)

    ma = jnp.maximum(jnp.where(is_x, ax, jnp.where(is_y, ay, az)), 1e-30)

    sc = jnp.where(
        is_x,
        jnp.where(x >= 0, -z, z),
        jnp.where(is_y, x, jnp.where(z >= 0, x, -x)),
    )
    tc = jnp.where(is_y, jnp.where(y >= 0, z, -z), -y)

    s = 0.5 * (sc / ma + 1.0)
    t = 0.5 * (tc / ma + 1.0)
    return face, s, t


def cube_face_st(dirs: jnp.ndarray):
    """Map directions (..., 3) → (face (...,) int32, s (...,), t (...,))."""
    return face_st(dirs[..., 0], dirs[..., 1], dirs[..., 2])


def _bilinear_coords(s, t, h: int, w: int):
    """Half-texel-centered bilinear taps with clamp-to-edge addressing
    (sampler config ``src/main.cpp:2393-2406``).

    Returns ``(x0c, x1c, y0c, y1c, wx, wy)``.
    """
    fx = s * w - 0.5
    fy = t * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    wx = fx - x0
    wy = fy - y0
    x0c = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1c = jnp.clip(x0.astype(jnp.int32) + 1, 0, w - 1)
    y0c = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1c = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    return x0c, x1c, y0c, y1c, wx, wy


def _unpack_rgb8(word):
    """uint32 (R | G<<8 | B<<16) → float RGB tuple in [0, 1]."""
    inv = jnp.float32(1.0 / 255.0)
    return (
        (word & 0xFF).astype(jnp.float32) * inv,
        ((word >> 8) & 0xFF).astype(jnp.float32) * inv,
        ((word >> 16) & 0xFF).astype(jnp.float32) * inv,
    )


def sample_cubemap_u32_nearest(skybox_u32: jnp.ndarray, h: int, w: int, dirs):
    """Single-tap lookup into a packed RGB8 cube map: ONE gather per lane.

    With ``skybox_u32_2x`` (the 2× bilinear-prefiltered map) this equals
    bilinear filtering with weights quantized to the half-texel grid — a
    quarter-texel max error — at a quarter of the gather cost.
    """
    face, s, t = face_st(*dirs)
    xc = jnp.clip(jnp.floor(s * w).astype(jnp.int32), 0, w - 1)
    yc = jnp.clip(jnp.floor(t * h).astype(jnp.int32), 0, h - 1)
    word = jnp.take(skybox_u32, face * (h * w) + yc * w + xc, axis=0)
    return _unpack_rgb8(word)


def sample_cubemap_u32(skybox_u32: jnp.ndarray, h: int, w: int, dirs):
    """Bilinear cube-map lookup from RGB8-packed-uint32 texels.

    ONE per-lane gather per bilinear tap (4 total) instead of one per
    channel. Unpacking is cheap bit math; sources are 8-bit faces, so
    packing loses nothing.

    ``skybox_u32``: (6·H·W,) uint32 (R | G<<8 | B<<16); ``dirs``: Vec3.
    Returns a Vec3 of linear RGB in [0, 1].
    """
    face, s, t = face_st(*dirs)
    x0c, x1c, y0c, y1c, wx, wy = _bilinear_coords(s, t, h, w)
    base = face * (h * w)

    def tap(yc, xc):
        return _unpack_rgb8(jnp.take(skybox_u32, base + yc * w + xc, axis=0))

    c00 = tap(y0c, x0c)
    c01 = tap(y0c, x1c)
    c10 = tap(y1c, x0c)
    c11 = tap(y1c, x1c)
    out = []
    for c in range(3):
        top = c00[c] * (1 - wx) + c01[c] * wx
        bot = c10[c] * (1 - wx) + c11[c] * wx
        out.append(top * (1 - wy) + bot * wy)
    return tuple(out)


def sample_cubemap(skybox: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
    """Bilinear cube-map lookup (AoS reference form, used by the oracle/tests).

    ``skybox``: (6, H, W, 3) float32 in face order +X,−X,+Y,−Y,+Z,−Z;
    ``dirs``: (R, 3) directions (need not be normalized — face math is
    scale-invariant). Returns (R, 3) linear RGB.
    """
    faces, s, t = cube_face_st(dirs)
    h, w = skybox.shape[1], skybox.shape[2]
    x0c, x1c, y0c, y1c, wx, wy = _bilinear_coords(s, t, h, w)
    wx = wx[..., None]
    wy = wy[..., None]

    flat = skybox.reshape(-1, 3)
    base = faces * (h * w)

    def tex(yc, xc):
        return jnp.take(flat, base + yc * w + xc, axis=0)

    c00 = tex(y0c, x0c)
    c01 = tex(y0c, x1c)
    c10 = tex(y1c, x0c)
    c11 = tex(y1c, x1c)
    top = c00 * (1 - wx) + c01 * wx
    bot = c10 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bot * wy

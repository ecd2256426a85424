"""Whitted integrator: the jitted `render` step (packet-wavefront form).

A reformulation of the raygen shader (``src/shader.rgen:61-186``, the
reference's per-pixel GPU program) as a **packet wavefront** program:

* pixels are generated in **tile-major order** (32×32 tiles → packets of
  K=1024 rays) so each packet is spatially coherent — the property the
  XLA packet walk (``ops/packet.py``) turns into dense elementwise work,
  and that keeps neighbouring lanes of the GPU traversal kernel
  (``ops/bvh_kernel.py``) on neighbouring paths through the tree;
* the reference's per-thread sample loop (``:70``) becomes a
  ``lax.fori_loop`` accumulating sample waves;
* the per-thread bounce loop (``:84``) becomes a ``lax.while_loop`` over the
  whole wave with per-lane ``active`` masks — it exits as soon as every lane
  has terminated, so typical scenes pay 2–4 traversal rounds, not 64. This
  is the reference's own iterative formulation (it sets
  ``maxPipelineRayRecursionDepth = 1`` and loops in the shader,
  ``src/main.cpp:1586``);
* material "branches" are masked elementwise math; the shadow trace is
  skipped entirely (``lax.cond``) when no lane needs it; terminated lanes
  hand traversal a ``tmax = 0`` window so packets full of dead lanes park
  at the root.

Semantic quirks reproduced (SSIM fidelity targets, SURVEY.md §7 "hard
parts"): hash-RNG pixel jitter (``:57-59,72-73``), focal length 2.5
(``:79``), NDC y-flip (``:75``), ambient init replaced (not blended) by the
skybox on miss (``:81,92``), skybox z-flip (``:92``), backface-break for
diffuse (``:104-105``), ``0.9^sample_index`` decay (``:128``), unused
distance attenuation (``:123``), ±0.01 normal offsets (``:107,136,158,164``),
tmin/tmax 0.001/10000 (``:87``), bounce loop inclusive of ``maxBounceCount``
(``:84``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from raytpu.config import (
    FOCAL_LENGTH,
    HIT_EPSILON,
    RAY_TMAX,
    RAY_TMIN,
    SAMPLE_DECAY,
    RenderConfig,
)
from raytpu.device_scene import DeviceScene, SceneStatic
from raytpu.ops import shade
from raytpu.ops import vec3 as v3
from raytpu.ops.sky import sample_cubemap_u32, sample_cubemap_u32_nearest
from raytpu.ops.trace import any_hit_wave, closest_hit_wave


# packet counts are padded to a multiple of this, so the compacted bounce
# waves (_wave_budget) find a divisor of the wave near a quarter of it
PACKET_GRANULE = 64


@dataclasses.dataclass(frozen=True)
class RenderStatic:
    """Hashable render parameters (static under jit)."""

    width: int
    height: int
    samples_per_pixel: int
    max_bounce_count: int
    ray_chunk: int = 0     # rays per chunk (grouped whole packets); 0 = all
    skybox_filter: str = "bilinear"  # see RenderConfig.skybox_filter
    wavefront: str = "compact"  # see RenderConfig.wavefront
    fold_spp: bool = True  # trace all spp waves in one folded sweep
    tile: int = 32         # pixel tile edge; packet size K = tile²
    validation: bool = False  # in-jit NaN guards (utils/validation.jit_guard)

    @property
    def packet_size(self) -> int:
        return self.tile * self.tile

    VALID_SKYBOX_FILTERS = ("bilinear2x", "bilinear", "nearest")

    def __post_init__(self):
        if self.skybox_filter not in self.VALID_SKYBOX_FILTERS:
            raise ValueError(
                f"unknown skybox_filter {self.skybox_filter!r}; "
                f"use one of {self.VALID_SKYBOX_FILTERS}"
            )

    @classmethod
    def from_config(cls, config: RenderConfig) -> "RenderStatic":
        return cls(
            width=config.width,
            height=config.height,
            samples_per_pixel=config.samples_per_pixel,
            max_bounce_count=config.max_bounce_count,
            ray_chunk=config.ray_chunk,
            skybox_filter=config.skybox_filter,
            wavefront=config.wavefront,
            validation=config.validation,
        )


def _wave_budget(p: int) -> int:
    """Compacted-wave row budget for ``wavefront="compact"``: the largest
    DIVISOR of P that is a PACKET_GRANULE multiple and ≤ ~P/4 (waves must
    tile P exactly — disjoint dynamic slices; P is always a granule
    multiple, see _tiled_pixels' padding). 0 disables compaction (no
    divisor gives a real subset, i.e. P < 2·PACKET_GRANULE)."""
    cap = max(p // 4, PACKET_GRANULE)
    best = 0
    b = PACKET_GRANULE
    while b <= cap:
        if p % b == 0:
            best = b
        b += PACKET_GRANULE
    return best if best * 2 <= p else 0


def hash_random(pix: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """The reference's shader-hash RNG (``src/shader.rgen:57-59``):
    ``fract(sin(dot(uv,(12.9898,78.233)) + 1113.1·seed) · 43758.5453)``.

    ``pix``: (..., 2) float32 integer pixel coords; ``seed``: scalar.
    """
    x = jnp.sum(pix * jnp.asarray([12.9898, 78.233], pix.dtype), axis=-1)
    x = jnp.sin(x + 1113.1 * seed) * 43758.5453
    return x - jnp.floor(x)


def primary_rays(
    pix: jnp.ndarray,        # (..., 2) float32 (x, y) pixel coords
    camera: jnp.ndarray,     # (4, 3): position, right, up, forward
    sample_idx: jnp.ndarray,  # scalar — the loop index i
    spp: int,
    width: int,
    height: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Jittered primary ray generation (``src/shader.rgen:70-79``).

    AoS (…, 3) variant, kept for the flat/sharded path and tests."""
    o3, d3 = primary_rays_soa(
        (pix[..., 0], pix[..., 1]), camera, sample_idx, spp, width, height
    )
    return v3.to_array(o3), v3.to_array(d3)


def primary_rays_soa(
    pix,                     # (px, py): two (...,) float32 pixel coords
    camera: jnp.ndarray,     # (4, 3)
    sample_idx: jnp.ndarray,
    spp: int,
    width: int,
    height: int,
):
    """Component-SoA jittered primary rays (the wave path)."""
    px, py = pix
    s = sample_idx.astype(jnp.float32)
    seed0 = jnp.float32(spp) + s          # seedOffset = samples (:69)

    def rnd(seed):
        x = jnp.sin(px * 12.9898 + py * 78.233 + 1113.1 * seed) * 43758.5453
        return x - jnp.floor(x)

    ux = ((px + rnd(seed0)) / width) * 2.0 - 1.0
    uy = -(((py + rnd(seed0 + 0.5)) / height) * 2.0 - 1.0)   # y-flip (:75)

    # camera rows are (3,) device arrays; components index as scalars
    right, up, fwd = camera[1], camera[2], camera[3]
    d = tuple(
        ux * right[c] + uy * up[c] + FOCAL_LENGTH * fwd[c] for c in range(3)
    )
    d = v3.normalize(d)
    o = tuple(jnp.broadcast_to(camera[0, c], d[0].shape) for c in range(3))
    return o, d


def _deferred_sky(scene, static, rs, missed, d, tmp):
    """Deferred once-per-wave skybox fetch + miss replacement
    (``src/shader.rgen:90-94``), z-flipped lookup. The exit-time ``d`` IS
    each miss lane's miss direction (see the no-carry note in
    ``_trace_sample``); non-miss lanes point at a fixed direction so their
    masked-out taps all read the same texels."""
    sky_h, sky_w = static.sky_hw
    mdx = jnp.where(missed, d[0], 0.0)
    mdy = jnp.where(missed, d[1], 0.0)
    mdz = jnp.where(missed, -d[2], 1.0)
    if rs.skybox_filter == "bilinear":
        sky = sample_cubemap_u32(
            scene.skybox_u32, sky_h, sky_w, (mdx, mdy, mdz)
        )
    elif rs.skybox_filter == "nearest":
        sky = sample_cubemap_u32_nearest(
            scene.skybox_u32, sky_h, sky_w, (mdx, mdy, mdz)
        )
    else:  # "bilinear2x": single tap into the 2x-prefiltered map
        sky = sample_cubemap_u32_nearest(
            scene.skybox_u32_2x, 2 * sky_h, 2 * sky_w, (mdx, mdy, mdz)
        )
    return v3.where(missed, sky, tmp)


def _trace_sample(
    scene: DeviceScene,
    static: SceneStatic,
    rs: RenderStatic,
    o,                       # Vec3 of (P, K)
    d,                       # Vec3 of (P, K)
    sample_idx: jnp.ndarray,
    active0: jnp.ndarray,    # (P, K) initial lane mask (padding excluded)
):
    """One sample wave through the bounce loop → Vec3 color of (P, K)."""
    p, k = o[0].shape
    amb = shade.ambient_tuple()
    tmp = tuple(jnp.full((p, k), c, jnp.float32) for c in amb)  # :81
    # 0.9^i quirk (:128); broadcast per-lane so compacted waves can slice it
    decay = jnp.broadcast_to(
        SAMPLE_DECAY ** sample_idx.astype(jnp.float32), (p, k)
    )
    # DEFERRED skybox: each lane misses at most once, so record the miss
    # during the loop and do the cubemap fetch exactly ONCE per sample wave
    # after the loop — instead of once per bounce iteration. Semantics
    # identical: on miss the color is REPLACED by the skybox and the lane
    # terminates (:90-94).
    # NO miss-direction carry: a lane misses at most once and goes
    # inactive forever, and ``d`` is only rewritten on live mirror/refract
    # continuations — so at loop exit ``d`` IS the recorded miss direction
    # for every miss_rec lane, exactly.
    miss_rec = jnp.zeros((p, k), bool)

    def cond(state):
        j, _, _, _, active, _ = state
        return (j <= rs.max_bounce_count) & jnp.any(active)  # inclusive :84

    def bounce_core(o, d, tmp, active, miss_rec, decay_):
        """One bounce iteration's work at the width of its inputs: closest
        trace, miss recording, shadow + Blinn-Phong, mirror/refract
        continuations. Per-lane results depend only on that lane's state,
        so the core runs identically over the full wave or over a
        compacted sub-wave (``rs.wavefront == "compact"``)."""
        pw, kw = o[0].shape
        lane_tmax = jnp.where(active, jnp.float32(RAY_TMAX), 0.0)
        hit = closest_hit_wave(scene, static, o, d, RAY_TMIN, lane_tmax)
        hit_mask = active & hit.is_hit
        miss_mask = active & ~hit.is_hit

        # --- miss → flag for the deferred skybox fetch (direction = the
        # lane's final d; see the no-carry note above) ---
        miss_rec = miss_rec | miss_mask

        # --- hit attributes (normal + material merged by the tracer) ---
        pos = v3.add(o, v3.scale(hit.t, d))
        n = hit.n
        mat = hit.mat
        is_diffuse = hit_mask & (mat == 0)
        is_mirror = hit_mask & (mat == 1)
        is_refract = hit_mask & (mat == 2)

        # --- diffuse: backface break (:104-105), shadow ray + Blinn-Phong ---
        front_face = v3.dot(d, n) < 0.0
        lit_candidate = is_diffuse & front_face
        shadow_o = v3.add(pos, v3.scale(HIT_EPSILON, n))
        to_light = tuple(scene.light_pos[c] - pos[c] for c in range(3))
        light_dist = v3.norm(to_light)
        l = v3.scale(1.0 / jnp.maximum(light_dist, 1e-30), to_light)

        def do_shadow(_):
            return any_hit_wave(
                scene, static, shadow_o, l, RAY_TMIN,
                jnp.where(lit_candidate, light_dist, 0.0),
            )

        # Shallow multi-sample loops run the shadow sweep unconditionally:
        # their dense spp-folded waves nearly always hold diffuse
        # candidates, and lanes with an empty window park at once. Sparse
        # spp=1 frames and deep loops (the 63-bounce reference preset
        # ping-pongs mirror/refract lanes with no diffuse candidates) skip
        # the sweep when no lane needs it. Results are identical either way:
        # zero windows produce occ == 0 exactly. The split was chosen
        # before the move to the GPU and has not been re-measured there.
        if rs.max_bounce_count <= 4 and rs.samples_per_pixel > 1:
            occluded = do_shadow(None)
        else:
            occluded = jax.lax.cond(
                jnp.any(lit_candidate),
                do_shadow,
                lambda _: jnp.zeros((pw, kw), bool),
                operand=None,
            )
        phong = shade.blinn_phong_soa(n, l, v3.neg(d), scene.light_intensity)
        shade_mask = lit_candidate & ~occluded
        zero_ = jnp.zeros((pw, kw), jnp.float32)
        tmp = v3.add(
            tmp,
            v3.where(shade_mask, v3.scale(decay_, phong),
                     (zero_, zero_, zero_)),
        )

        # --- mirror / refract continuations (:132-177) ---
        o_m, d_m = shade.mirror_bounce_soa(d, n, pos)
        o_r, d_r = shade.refract_bounce_soa(d, n, pos)
        cont = is_mirror | is_refract
        o = v3.where(cont, v3.where(is_mirror, o_m, o_r), o)
        d = v3.where(cont, v3.where(is_mirror, d_m, d_r), d)
        return o, d, tmp, cont, miss_rec

    def body(state):
        j, o, d, tmp, active, miss_rec = state
        o, d, tmp, cont, miss_rec = bounce_core(
            o, d, tmp, active, miss_rec, decay
        )
        return j + 1, o, d, tmp, cont, miss_rec

    budget = _wave_budget(p) if rs.wavefront == "compact" else 0
    assert budget == 0 or p % budget == 0  # waves must tile p exactly

    def body_compact(state):
        """Bounce iteration over a live-first compacted wave (SURVEY.md §2
        "divergent-bounce scheduling", at PACKET granularity where moves
        are contiguous row copies): after j=0 most packets are dead, so
        the per-bounce elementwise shading/bookkeeping and the sweeps run
        on a P/4-packet budget instead of the full wave. Packets sort
        live-first (a stable (P,)-sized argsort), waves of `budget` rows
        process through `bounce_core` via contiguous dynamic slices, and
        the inverse permutation restores frame order. Per-lane results
        are permutation-invariant, so this is bit-identical to the
        full-width body. The budget DIVIDES p (_wave_budget picks a
        divisor), so the tail-wave clamp below never engages: waves are
        disjoint. (With a non-divisor budget a clamped tail wave would
        overlap the previous wave and re-apply bounce_core to
        already-bounced live rows — an extra bounce, NOT an identical
        recompute; the divisor rule is what makes this path exact.)"""
        j, o, d, tmp, active, miss_rec = state
        packet_live = jnp.any(active, axis=1)
        order = jnp.argsort(~packet_live, stable=True)      # live first
        inv = jnp.argsort(order, stable=True)

        def g(x):
            return jnp.take(x, order, axis=0)

        planes = (
            g(o[0]), g(o[1]), g(o[2]), g(d[0]), g(d[1]), g(d[2]),
            g(tmp[0]), g(tmp[1]), g(tmp[2]), g(active), g(miss_rec),
        )
        decay_p = g(decay)
        n_live = jnp.sum(packet_live, dtype=jnp.int32)
        n_waves = (n_live + budget - 1) // budget

        def wave(c, planes):
            start = jnp.minimum(c * budget, p - budget)

            def sl(x):
                return jax.lax.dynamic_slice_in_dim(x, start, budget, 0)

            (ox, oy, oz, dx, dy, dz, t0, t1, t2, act, mr) = planes
            ow, dw, tw, cw, mrw = bounce_core(
                (sl(ox), sl(oy), sl(oz)), (sl(dx), sl(dy), sl(dz)),
                (sl(t0), sl(t1), sl(t2)), sl(act), sl(mr), sl(decay_p)
            )
            upd = jax.lax.dynamic_update_slice_in_dim
            return (
                upd(ox, ow[0], start, 0), upd(oy, ow[1], start, 0),
                upd(oz, ow[2], start, 0), upd(dx, dw[0], start, 0),
                upd(dy, dw[1], start, 0), upd(dz, dw[2], start, 0),
                upd(t0, tw[0], start, 0), upd(t1, tw[1], start, 0),
                upd(t2, tw[2], start, 0), upd(act, cw, start, 0),
                upd(mr, mrw, start, 0),
            )

        planes = jax.lax.while_loop(
            lambda cp: cp[0] < n_waves,
            lambda cp: (cp[0] + 1, wave(cp[0], cp[1])),
            (jnp.int32(0), planes),
        )[1]

        def u(x):
            return jnp.take(x, inv, axis=0)

        (ox, oy, oz, dx, dy, dz, t0, t1, t2, act, mr) = planes
        return (
            j + 1, (u(ox), u(oy), u(oz)), (u(dx), u(dy), u(dz)),
            (u(t0), u(t1), u(t2)), u(act), u(mr),
        )

    # with compaction, j=0 is peeled out of the loop: the dense primary
    # iteration runs full width, later iterations over compacted waves. If
    # the whole wave is dead (sharded padding shards) the peeled sweeps
    # see all-zero windows and park at once.
    state0 = (jnp.int32(0), o, d, tmp, active0, miss_rec)
    if budget:
        state0 = body(state0)
    _, _, d, tmp, _, miss_rec = jax.lax.while_loop(
        cond, body_compact if budget else body, state0
    )
    if rs.validation:
        # per-frame in-jit NaN guard on the accumulated radiance + final
        # ray directions (synchronization-validation analog, SURVEY.md §5)
        from raytpu.utils.validation import jit_guard

        tmp = jit_guard(tmp, "bounce-loop radiance")
        d = jit_guard(d, "final ray directions")
    return _deferred_sky(scene, static, rs, miss_rec, d, tmp)


def render_packets(
    scene: DeviceScene,
    static: SceneStatic,
    rs: RenderStatic,
    camera: jnp.ndarray,   # (4, 3)
    px: jnp.ndarray,       # (P, K) float32 pixel x coords (tile-major)
    py: jnp.ndarray,       # (P, K) float32 pixel y coords
    active0: jnp.ndarray,  # (P, K) lane mask (frame-padding excluded)
):
    """Render packets of pixels → Vec3 color of (P, K) (sample-averaged).

    All spp sample waves are FOLDED into the packet dimension and traced in
    one sweep (``fold_spp``): traversal and the deferred skybox fetch run
    once over spp× packets instead of over spp sequential waves. Per-lane
    sample indices drive the jitter seeds and the ``0.9^sample_index``
    decay exactly as the reference's sample loop (``src/shader.rgen:70``)."""
    p, k = px.shape
    spp = rs.samples_per_pixel

    if rs.fold_spp and spp > 1:
        # packet t*spp+s = tile t, sample s: the spp near-identical sample
        # packets of one tile sit next to each other in the wave
        pxs = jnp.repeat(px, spp, axis=0)      # (spp·P, K)
        pys = jnp.repeat(py, spp, axis=0)
        act = jnp.repeat(active0, spp, axis=0)
        s_idx = jnp.tile(
            jnp.arange(spp, dtype=jnp.float32), (p,)
        )[:, None] * jnp.ones((1, k), jnp.float32)
        o, d = primary_rays_soa((pxs, pys), camera, s_idx, spp,
                                rs.width, rs.height)
        colors = _trace_sample(scene, static, rs, o, d, s_idx, act)
        return tuple(
            c.reshape(p, spp, k).mean(axis=1) for c in colors
        )  # :183

    def sample_body(i, accum):
        o, d = primary_rays_soa(
            (px, py), camera, i, spp, rs.width, rs.height
        )
        return v3.add(
            accum, _trace_sample(scene, static, rs, o, d, i, active0),
        )

    zero = jnp.zeros((p, k), jnp.float32)
    accum = jax.lax.fori_loop(0, spp, sample_body, (zero, zero, zero))
    return v3.scale(1.0 / spp, accum)  # :183


def _pad_packets(planes, granule: int, fill):
    """Pad (P, K) planes to a packet count that is a ``granule`` multiple;
    padding packets take ``fill`` (dead lanes)."""
    p = planes[0].shape[0]
    pad = (-p) % granule
    if not pad:
        return planes
    return tuple(
        jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], f, x.dtype)])
        for x, f in zip(planes, fill)
    )


# flat (R, 2) pixel batches are reshaped into packets of rs.packet_size
def render_pixels(
    scene: DeviceScene,
    static: SceneStatic,
    rs: RenderStatic,
    camera: jnp.ndarray,
    pix: jnp.ndarray,  # (R, 2)
) -> jnp.ndarray:
    r = pix.shape[0]
    k = min(rs.packet_size, r)
    pad = (-r) % k
    px = jnp.pad(pix[:, 0], (0, pad)).reshape(-1, k)
    py = jnp.pad(pix[:, 1], (0, pad)).reshape(-1, k)
    px, py = _pad_packets((px, py), PACKET_GRANULE, (0, 0))
    active0 = (
        jnp.arange(px.size, dtype=jnp.int32).reshape(px.shape) < r
    )
    colors = render_packets(scene, static, rs, camera, px, py, active0)
    return v3.to_array(colors).reshape(-1, 3)[:r]


def _tiled_pixels(rs: RenderStatic):
    """Tile-major pixel packets + flat scatter indices (component form).

    Returns ``(px, py)`` (P, K) float32, ``flat_idx`` (P, K) int32 =
    ``y*W + x`` (out-of-frame padding lanes get W*H, dropped at scatter),
    and ``in_frame`` (P, K) bool. Tile-major ordering is what makes packets
    spatially coherent. The packet count is padded to a PACKET_GRANULE
    multiple; padding packets are fully dead, so every sweep parks them at
    once.
    """
    t = rs.tile
    w_t = -(-rs.width // t)
    h_t = -(-rs.height // t)
    ty, tx = jnp.mgrid[0:h_t, 0:w_t]           # tile grid
    iy, ix = jnp.mgrid[0:t, 0:t]               # intra-tile
    xs = (tx.reshape(-1, 1) * t + ix.reshape(1, -1)).astype(jnp.int32)  # (P, K)
    ys = (ty.reshape(-1, 1) * t + iy.reshape(1, -1)).astype(jnp.int32)
    in_frame = (xs < rs.width) & (ys < rs.height)
    flat_idx = jnp.where(
        in_frame, ys * rs.width + xs, jnp.int32(rs.width * rs.height)
    )
    px = jnp.minimum(xs, rs.width - 1).astype(jnp.float32)
    py = jnp.minimum(ys, rs.height - 1).astype(jnp.float32)
    px, py, in_frame, flat_idx = _pad_packets(
        (px, py, in_frame, flat_idx), PACKET_GRANULE,
        (0, 0, False, rs.width * rs.height),
    )
    return (px, py), flat_idx, in_frame


@functools.partial(jax.jit, static_argnums=(1, 2))
def render_frame(
    scene: DeviceScene,
    static: SceneStatic,
    rs: RenderStatic,
    camera: jnp.ndarray,
) -> jnp.ndarray:
    """Full-frame render → (H, W, 3) float32 image.

    The jitted frame step: the analog of one recorded
    ``vkCmdTraceRaysKHR(W, H, 1)`` dispatch (``src/main.cpp:2620-2624``),
    with camera and instance transforms as plain inputs so interactive
    updates never recompile.
    """
    (px, py), flat_idx, in_frame = _tiled_pixels(rs)
    p, k = px.shape

    chunk_packets = 0
    if rs.ray_chunk:
        chunk_packets = max(1, rs.ray_chunk // rs.packet_size)
        # whole granules per chunk, so each chunk keeps its compaction
        # divisors
        chunk_packets = -(-chunk_packets // PACKET_GRANULE) * PACKET_GRANULE
    if chunk_packets and chunk_packets < p:
        pad = (-p) % chunk_packets
        pad3 = ((0, pad), (0, 0))
        gx = jnp.pad(px, pad3).reshape(-1, chunk_packets, k)
        gy = jnp.pad(py, pad3).reshape(-1, chunk_packets, k)
        ga = jnp.pad(in_frame, pad3).reshape(-1, chunk_packets, k)
        colors3 = jax.lax.map(
            lambda g: v3.to_array(
                render_packets(scene, static, rs, camera, g[0], g[1],
                               g[2] != 0)
            ),
            (gx, gy, ga.astype(jnp.int32)),
        )
        colors3 = colors3.reshape(-1, k, 3)[:p]
        colors = (colors3[..., 0], colors3[..., 1], colors3[..., 2])
    else:
        colors = render_packets(scene, static, rs, camera, px, py, in_frame)

    return detile(colors, rs)


def detile(colors, rs: RenderStatic) -> jnp.ndarray:
    """Structural detile (pure reshape/transpose — no scatter): packets are
    (Ht*Wt) tiles of (tile*tile) pixels in row-major intra-tile order
    (padding packets are sliced away first)."""
    t = rs.tile
    h_t = -(-rs.height // t)
    w_t = -(-rs.width // t)
    planes = [
        c[: h_t * w_t]
        .reshape(h_t, w_t, t, t)
        .transpose(0, 2, 1, 3)
        .reshape(h_t * t, w_t * t)[: rs.height, : rs.width]
        for c in colors
    ]
    return jnp.stack(planes, axis=-1)

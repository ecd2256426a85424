"""Benchmark harness: frame time, FPS and traced Mrays/s on the local card.

The reference's only benchmark is an FPS print with vsync off
(``src/main.cpp:65-81,1214-1218``). Here every preset is rendered through
the normal ``Renderer`` path and timed frame by frame with
``block_until_ready`` (compile excluded and reported apart). Ray counting is
exact: an instrumented render variant accumulates the number of *active*
closest-hit lanes per bounce plus shadow rays — the same definition a GPU
ray counter would report (each ``traceRayEXT`` invocation counts once,
``src/shader.rgen:86,111``).

Every result names the device it ran on; ``require_gpu`` refuses to
measure anything else.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from raytpu.config import RAY_TMAX, RAY_TMIN
from raytpu.device_scene import DeviceScene, SceneStatic
from raytpu.integrator import RenderStatic, render_frame
from raytpu.presets import load_preset_scene
from raytpu.render import Renderer
from raytpu.utils import measure_frame

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# exact per-frame ray counts, recounted on first use (gitignored)
RAYCOUNT_SIDECAR = os.path.join(_REPO_ROOT, "raycounts.json")


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one
    line each, exactly as the tool prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def device_info() -> Dict:
    """The device as JAX reports it (platform, kind, count)."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> Dict:
    """Device info plus the card's name and power limit; raises when JAX
    finds no GPU — numbers from another device are not measured here."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {info['platform']!r} "
            f"({info['kind']}); refusing to measure")
    info["name_power_limit"] = gpu_name_and_power_limit()
    return info


def _raycount_key(preset: str, rs: RenderStatic, highpoly_depth: int,
                  platform: str) -> str:
    """Sidecar key: everything the exact per-frame ray count depends on.
    Frames are deterministic (hash RNG seeded by pixel coords + sample
    index; camera from ``set_transforms(0.0)``), so the count for a
    (preset, shapes, platform) tuple never changes between runs. The
    platform is in the key because traversal uses strict f32 comparisons
    whose rounding differs across platforms."""
    return (f"{preset}:{rs.width}x{rs.height}:spp{rs.samples_per_pixel}"
            f":b{rs.max_bounce_count}:d{highpoly_depth}:{platform}")


def _raycount_lookup(key: str) -> Optional[int]:
    try:
        with open(RAYCOUNT_SIDECAR) as f:
            return json.load(f).get(key)
    except (OSError, ValueError):
        return None


def _raycount_store(key: str, rays: int) -> None:
    data = {}
    try:
        with open(RAYCOUNT_SIDECAR) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    data[key] = rays
    try:
        with open(RAYCOUNT_SIDECAR, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
    except OSError:
        pass  # read-only checkout: the sidecar is only a cache


def count_rays_frame(
    scene: DeviceScene, static: SceneStatic, rs: RenderStatic, camera
) -> int:
    """Exact traced-ray count for one frame (closest-hit + shadow rays),
    replaying the integrator's packet control flow with counters instead of
    shading. Small (runs once per benchmark config, off the hot path)."""
    from raytpu.integrator import _tiled_pixels, primary_rays_soa
    from raytpu.ops import shade
    from raytpu.ops import vec3 as v3
    from raytpu.ops.trace import closest_hit_wave

    (px, py), _, real_lane = _tiled_pixels(rs)
    camera = jnp.asarray(camera)

    @jax.jit
    def count(scene, camera):
        total = jnp.zeros((), jnp.int32)

        def sample_body(i, total):
            o, d = primary_rays_soa((px, py), camera, i, rs.samples_per_pixel,
                                    rs.width, rs.height)
            active = real_lane

            def cond(state):
                j, _, _, _, active = state
                return (j <= rs.max_bounce_count) & jnp.any(active)

            def body(state):
                j, o, d, total, active = state
                total = total + jnp.sum(active, dtype=jnp.int32)  # closest traces
                lane_tmax = jnp.where(active, jnp.float32(RAY_TMAX), 0.0)
                hit = closest_hit_wave(scene, static, o, d, RAY_TMIN, lane_tmax)
                hit_mask = active & hit.is_hit
                n = hit.n
                mat = hit.mat
                is_diffuse = hit_mask & (mat == 0)
                front = v3.dot(d, n) < 0.0
                total = total + jnp.sum(is_diffuse & front, dtype=jnp.int32)  # shadow
                pos = v3.add(o, v3.scale(hit.t, d))

                o_m, d_m = shade.mirror_bounce_soa(d, n, pos)
                o_r, d_r = shade.refract_bounce_soa(d, n, pos)
                cont = hit_mask & ((mat == 1) | (mat == 2))
                is_mirror = hit_mask & (mat == 1)
                o = v3.where(cont, v3.where(is_mirror, o_m, o_r), o)
                d = v3.where(cont, v3.where(is_mirror, d_m, d_r), d)
                return j + 1, o, d, total, cont

            _, _, _, total, _ = jax.lax.while_loop(
                cond, body, (jnp.int32(0), o, d, total, active)
            )
            return total

        return jax.lax.fori_loop(0, rs.samples_per_pixel, sample_body, total)

    return int(count(scene, camera))


def build_preset_renderer(preset, highpoly_depth: int = 7,
                          spp: Optional[int] = None) -> Renderer:
    """Build (scene + BVH + device upload) a preset's Renderer once, so
    several measurements of the same preset share it."""
    scene = load_preset_scene(preset, highpoly_depth=highpoly_depth)
    if spp is not None:
        scene.config = scene.config.replace(samples_per_pixel=spp)
    renderer = Renderer(scene)
    renderer.set_transforms(0.0)
    return renderer


def run_benchmark(
    preset="config4",
    frames: int = 10,
    highpoly_depth: int = 7,
    spp: Optional[int] = None,
    count: bool = True,
    devices: int = 1,
    renderer: Optional[Renderer] = None,
    traversal: Optional[str] = None,
) -> Dict:
    """Benchmark a preset name or a fully-specified RenderConfig: compile
    time, then the steady frame time over ``frames`` frames, each blocked
    on the device (``block_until_ready``), with exact Mrays/s and FPS.

    ``devices > 1`` benches the SHARDED path (``parallel.render_sharded``
    over a 1-D mesh of that many devices). ``traversal`` ("kernel" /
    "xla") overrides the scene's resolved walk, for comparing the two on
    one renderer. ``renderer``: a pre-built Renderer to reuse."""
    if renderer is None:
        renderer = build_preset_renderer(preset, highpoly_depth, spp)
    rs = renderer.render_static
    cam = jnp.asarray(renderer.camera.basis())
    static = renderer.static
    if traversal is not None:
        static = dataclasses.replace(static, traversal=traversal)
    platform = jax.devices()[0].platform

    rays = None
    key = None
    if count and isinstance(preset, str) and spp is None:
        key = _raycount_key(preset, rs, highpoly_depth, platform)
        rays = _raycount_lookup(key)
    if rays is None and count:
        rays = count_rays_frame(renderer.device_scene, static, rs, cam)
        if key is not None:
            _raycount_store(key, rays)

    if devices > 1:
        from raytpu.parallel.dist import make_mesh, render_sharded

        mesh = make_mesh(devices)

        def frame():
            return render_sharded(renderer.device_scene, static, rs, cam,
                                  mesh=mesh)
    else:
        def frame():
            return render_frame(renderer.device_scene, static, rs, cam)

    t0 = time.perf_counter()
    jax.block_until_ready(frame())          # compiles; also the warm-up
    compile_s = time.perf_counter() - t0
    mean_s, times = measure_frame(frame, warmup=0, iters=frames,
                                  pipelined=False)
    return {
        "preset": preset if isinstance(preset, str) else "custom",
        "traversal": static.traversal,
        **device_info(),
        **({"devices": devices} if devices > 1 else {}),
        "width": rs.width,
        "height": rs.height,
        "spp": rs.samples_per_pixel,
        "max_bounces": rs.max_bounce_count,
        "rays_per_frame": rays,
        "compile_s": compile_s,
        "frame_ms": mean_s * 1e3,
        "frame_ms_min": min(times) * 1e3,
        "fps": 1.0 / mean_s,
        "mrays_per_s": rays / mean_s / 1e6 if rays else None,
        "frame_times_ms": [t * 1e3 for t in times],
    }

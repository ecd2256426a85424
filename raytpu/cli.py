"""raytpu command-line interface.

The reference is configured at compile time (``include/config.h``) and run
as ``./main``; raytpu exposes the same knobs as CLI flags over the preset
system:

    python -m raytpu.cli render   --preset config2 -o out.png
    python -m raytpu.cli render   --mesh a.obj:mirror --mesh b.obj:diffuse:orbit
    python -m raytpu.cli flythrough --preset config5 --frames 120 -o frames/
    python -m raytpu.cli bench    --preset config4
    python -m raytpu.cli interactive --preset reference
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from raytpu.config import MaterialType, ObjectConfig, RenderConfig
from raytpu.presets import PRESETS, load_preset_scene
from raytpu.utils import log

_MATERIALS = {
    "diffuse": MaterialType.DIFFUSE,
    "mirror": MaterialType.MIRROR,
    "refractive": MaterialType.REFRACTIVE,
    "0": MaterialType.DIFFUSE,
    "1": MaterialType.MIRROR,
    "2": MaterialType.REFRACTIVE,
}


def _parse_mesh_spec(spec: str) -> ObjectConfig:
    """``path[:material[:animation]]`` → ObjectConfig.

    The path may itself contain a URI scheme (``generated://armadillo``),
    so the split skips past any ``://``.
    """
    scheme_end = spec.find("://")
    tail_start = scheme_end + 3 if scheme_end >= 0 else 0
    tail = spec[tail_start:].split(":")
    parts = [spec[:tail_start] + tail[0]] + tail[1:]
    path = parts[0]
    if len(parts) > 1 and parts[1].lower() not in _MATERIALS:
        raise SystemExit(
            f"unknown material {parts[1]!r}; use diffuse/mirror/refractive (or 0/1/2)"
        )
    material = _MATERIALS[parts[1].lower()] if len(parts) > 1 else MaterialType.DIFFUSE
    animation = parts[2] if len(parts) > 2 else "static"
    if animation not in ("static", "spin", "orbit"):
        raise SystemExit(f"unknown animation {animation!r}; use static/spin/orbit")
    return ObjectConfig(path, material, animation)


def _build_config(args) -> RenderConfig:
    if args.mesh:
        cfg = RenderConfig(
            objects=tuple(_parse_mesh_spec(m) for m in args.mesh),
            skybox_dir=args.skybox,
        )
    else:
        name = args.preset or "reference"
        if name not in PRESETS:
            raise SystemExit(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
        cfg = PRESETS[name]()
        if args.skybox:
            cfg = cfg.replace(skybox_dir=args.skybox)
    overrides = {}
    for field in ("width", "height", "samples_per_pixel", "max_bounce_count",
                  "ray_chunk", "devices", "traversal", "wavefront"):
        v = getattr(args, field, None)
        if v is not None:
            overrides[field] = v
    if args.light is not None:
        overrides["light_position"] = tuple(args.light)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def _add_scene_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", help=f"scene preset: {sorted(PRESETS)}")
    p.add_argument(
        "--mesh",
        action="append",
        help="mesh spec path[:material[:animation]] (repeatable; overrides preset)",
    )
    p.add_argument("--skybox", help="cubemap directory (6 faces)")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--samples-per-pixel", type=int, dest="samples_per_pixel")
    p.add_argument("--max-bounce-count", type=int, dest="max_bounce_count")
    p.add_argument("--ray-chunk", type=int, dest="ray_chunk")
    p.add_argument("--traversal", choices=("auto", "kernel", "xla", "brute"),
                   help="traversal walk (default auto: the kernel on a GPU)")
    p.add_argument("--wavefront", choices=("full", "compact"),
                   help="bounce-loop scheduling (see RenderConfig)")
    p.add_argument("--light", type=float, nargs=3, metavar=("X", "Y", "Z"))
    p.add_argument("--devices", type=int,
                   help="shard pixel tiles across N devices")
    p.add_argument("--highpoly-depth", type=int, default=7,
                   help="subdivision depth for generated:// meshes")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("-v", "--verbose", action="store_true")


def _apply_platform(args) -> None:
    if getattr(args, "cpu", False):
        import jax

        jax.config.update("jax_platforms", "cpu")
    if getattr(args, "verbose", False):
        log.set_level("verbose")


def cmd_render(args) -> int:
    _apply_platform(args)
    from raytpu.frontend.headless import render_still

    cfg = _build_config(args)
    render_still(cfg, args.output, time_param=args.time,
                 highpoly_depth=args.highpoly_depth)
    return 0


def cmd_flythrough(args) -> int:
    _apply_platform(args)
    import os

    from raytpu.frontend.flythrough import Flythrough
    from raytpu.io.image import write_image

    cfg = _build_config(args)
    scene = load_preset_scene(cfg, highpoly_depth=args.highpoly_depth)
    fly = Flythrough(scene)
    if args.output:
        os.makedirs(args.output, exist_ok=True)
    n = 0
    for idx, img in fly.frames():
        if args.output:
            write_image(f"{args.output}/frame_{idx:05d}.png", img)
        n += 1
        if args.frames and n >= args.frames:
            break
    log.info(f"flythrough rendered {n} frames")
    return 0


def cmd_bench(args) -> int:
    _apply_platform(args)
    from raytpu.bench import require_gpu, run_benchmark

    info = require_gpu()
    if args.preset is None and not args.mesh:
        args.preset = "config4"
    result = run_benchmark(
        preset=_build_config(args),
        frames=args.frames or 10,
        highpoly_depth=args.highpoly_depth,
    )
    result["name_power_limit"] = info["name_power_limit"]
    print(json.dumps(result))
    return 0


def cmd_interactive(args) -> int:
    _apply_platform(args)
    from raytpu.frontend.interactive import run_interactive

    cfg = _build_config(args)
    scene = load_preset_scene(cfg, highpoly_depth=args.highpoly_depth)
    run_interactive(scene)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="raytpu", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one frame to an image file")
    _add_scene_args(p)
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--time", type=float, default=0.0,
                   help="animation timeParam (reference: elapsed*0.1)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("flythrough", help="scripted WASD/mouse camera trace")
    _add_scene_args(p)
    p.add_argument("-o", "--output", help="directory for frames (omit to skip IO)")
    p.add_argument("--frames", type=int, help="max frames")
    p.set_defaults(fn=cmd_flythrough)

    p = sub.add_parser("bench", help="GPU frame-time benchmark (one JSON line)")
    _add_scene_args(p)
    p.add_argument("--frames", type=int)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("interactive", help="windowed WASD+mouse viewer")
    _add_scene_args(p)
    p.set_defaults(fn=cmd_interactive)

    args = parser.parse_args(argv)
    from raytpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

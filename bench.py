#!/usr/bin/env python
"""Benchmark every preset on the local GPU.

    python bench.py                          # all six presets, the kernel
    python bench.py --traversal kernel,xla   # both walks, per preset
    python bench.py --presets config4 --frames 20

Prints the card's name and power limit, one JSON line per (preset,
traversal) as it finishes, and last a JSON summary with the device as JAX
reports it. Exits non-zero when JAX finds no GPU or any preset fails.
"""

import argparse
import json
import os
import sys

PRESET_ORDER = ("config1", "config2", "config3", "config4", "config5",
                "reference")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--presets", default=",".join(PRESET_ORDER))
    ap.add_argument("--traversal", default="kernel",
                    help="comma list of walks to time: kernel, xla")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--highpoly-depth", type=int, default=7)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from raytpu.bench import build_preset_renderer, require_gpu, run_benchmark
    from raytpu.utils.cache import enable_compilation_cache

    info = require_gpu()
    print(info["name_power_limit"], flush=True)
    cache_dir = enable_compilation_cache()

    rows = []
    for preset in args.presets.split(","):
        renderer = build_preset_renderer(preset, args.highpoly_depth)
        for walk in args.traversal.split(","):
            r = run_benchmark(preset, frames=args.frames,
                              highpoly_depth=args.highpoly_depth,
                              renderer=renderer, traversal=walk)
            r["name_power_limit"] = info["name_power_limit"]
            print(json.dumps(r), flush=True)
            rows.append(r)
        del renderer
    summary = {
        "device": {k: info[k] for k in ("platform", "kind", "count")},
        "name_power_limit": info["name_power_limit"],
        "compile_cache": cache_dir,
        "results": {
            f"{r['preset']}/{r['traversal']}": {
                k: r[k] for k in ("frame_ms", "fps", "mrays_per_s",
                                  "compile_s", "rays_per_frame")
            }
            for r in rows
        },
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

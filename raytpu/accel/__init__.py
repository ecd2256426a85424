"""Acceleration structures: BVH builders + scene attachment.

The BLAS/TLAS layer (reference: driver-built structures at
``src/main.cpp:495-498,730-733``). ``attach_bvh`` builds one threaded BVH
per mesh on the host, concatenates node/triangle arrays, records static
per-mesh ranges and resolves which walk the scene-level tracer
(``raytpu/ops/trace.py``) uses.
"""

from __future__ import annotations

import dataclasses

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from raytpu.accel.bvh import Bvh, build_bvh, validate_bvh
from raytpu.device_scene import DeviceScene, SceneStatic
from raytpu.scene import Scene

__all__ = ["Bvh", "build_bvh", "validate_bvh", "attach_bvh",
           "resolve_traversal"]

TRAVERSALS = ("auto", "kernel", "xla", "brute")


def resolve_traversal(requested: str, platform: str | None = None) -> str:
    """``RenderConfig.traversal`` → the walk a scene uses.

    ``"auto"`` follows the platform: the traversal kernel on ``gpu``, the
    XLA packet walk on ``cpu`` (the test platform). Any other platform is
    an error rather than a silent fallback."""
    if requested not in TRAVERSALS:
        raise ValueError(
            f"unknown traversal {requested!r}; use one of {TRAVERSALS}")
    if requested != "auto":
        return requested
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no traversal for platform {platform!r}")


def attach_bvh(
    dev: DeviceScene,
    static: SceneStatic,
    scene: Scene,
    method: str | None = None,
    leaf_size: int | None = None,
) -> Tuple[DeviceScene, SceneStatic]:
    """Build per-mesh BVHs and attach the concatenated arrays.

    Triangle intersection data is re-ordered into leaf-contiguous order
    (``bvh_tri_*``) with ``bvh_tri_prim`` mapping back to global primitive
    ids so shading attribute fetch (normals) is unchanged.
    """
    cfg = scene.config
    traversal = resolve_traversal(cfg.traversal)
    if method is None:
        method = cfg.bvh_builder
    if method in ("auto", "native"):
        # native C++ builder preferred when built; SAH otherwise
        from raytpu.accel import native as native_accel

        method = "native" if native_accel.available() else "sah"
    if leaf_size is None:
        leaf_size = cfg.leaf_size
    from raytpu.ops.intersect import LEAF_UNROLL

    if leaf_size > LEAF_UNROLL:
        raise ValueError(
            f"leaf_size {leaf_size} exceeds traversal LEAF_UNROLL {LEAF_UNROLL}"
        )

    v0_all = np.asarray(dev.tri_v0)
    e1_all = np.asarray(dev.tri_e1)
    e2_all = np.asarray(dev.tri_e2)

    def build(v0, e1, e2):
        if method == "native":
            from raytpu.accel import native as native_accel

            return native_accel.build_bvh(v0, e1, e2, leaf_size=leaf_size)
        if method == "lbvh":
            from raytpu.accel.lbvh import build_lbvh

            return build_lbvh(v0, e1, e2, leaf_size=leaf_size)
        return build_bvh(v0, e1, e2, leaf_size=leaf_size, method=method)

    node_min, node_max, tri_first, tri_count, miss = [], [], [], [], []
    bvh_v0, bvh_e1, bvh_e2, bvh_prim = [], [], [], []
    node_ranges, tri_ranges = [], []
    node_acc = tri_acc = 0

    for start, count in static.mesh_prim_ranges:
        v0 = v0_all[start : start + count]
        e1 = e1_all[start : start + count]
        e2 = e2_all[start : start + count]
        bvh = build(v0, e1, e2)
        node_ranges.append((node_acc, bvh.num_nodes))
        tri_ranges.append((tri_acc, bvh.num_triangles))
        node_acc += bvh.num_nodes
        tri_acc += bvh.num_triangles

        node_min.append(bvh.aabb_min)
        node_max.append(bvh.aabb_max)
        tri_first.append(bvh.tri_first)
        tri_count.append(bvh.tri_count)
        miss.append(bvh.miss)
        order = bvh.tri_order.astype(np.int64)
        bvh_v0.append(v0[order])
        bvh_e1.append(e1[order])
        bvh_e2.append(e2[order])
        bvh_prim.append((order + start).astype(np.int32))

    arrays = dict(
        bvh_aabb_min=np.concatenate(node_min),
        bvh_aabb_max=np.concatenate(node_max),
        bvh_tri_first=np.concatenate(tri_first),
        bvh_tri_count=np.concatenate(tri_count),
        bvh_miss=np.concatenate(miss),
        bvh_tri_v0=np.concatenate(bvh_v0),
        bvh_tri_e1=np.concatenate(bvh_e1),
        bvh_tri_e2=np.concatenate(bvh_e2),
        bvh_tri_prim=np.concatenate(bvh_prim),
    )
    from raytpu.ops.bvh_kernel import pack_tables

    prim = arrays["bvh_tri_prim"].astype(np.int64)
    kernel_tables = pack_tables(
        arrays["bvh_aabb_min"], arrays["bvh_aabb_max"],
        arrays["bvh_tri_first"], arrays["bvh_tri_count"],
        arrays["bvh_miss"], node_ranges, tri_ranges,
        arrays["bvh_tri_v0"], arrays["bvh_tri_e1"], arrays["bvh_tri_e2"],
        np.asarray(dev.tri_n_soa)[:, prim],
    )
    dev = dev._replace(
        kernel_tables=kernel_tables,
        **{k: jnp.asarray(v) for k, v in arrays.items()},
    )

    # replace() keeps every field not owned by the BVH stage (e.g. sky_hw)
    static_out = dataclasses.replace(
        static,
        mesh_node_ranges=tuple(node_ranges),
        mesh_bvh_tri_ranges=tuple(tri_ranges),
        traversal=traversal,
    )
    return dev, static_out

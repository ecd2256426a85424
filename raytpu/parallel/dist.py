"""Multi-chip rendering: pixel-tile sharding over a device mesh.

The reference is strictly single-GPU (one queue, ``src/main.cpp:1017-1024``);
the scale axis here is rays — embarrassingly parallel — so raytpu shards
whole **tile rows of the 32×32 tile-major packet stream** across devices
with ``shard_map`` over a 1-D ``jax.sharding.Mesh`` (SURVEY.md §5): every
device runs the identical single-device hot path on its packet slice and
detiles its own contiguous image row slab. Scene data (BVH + triangles +
skybox, ≤ a few hundred MB) is replicated per device; no collective is
needed inside a frame — the frame stays row-sharded, and XLA emits an
all-gather only if a consumer asks for the replicated image. A 1-D mesh
suits cards that reach each other at the same rate.

For scenes exceeding one device's memory, the extension point is BVH
sharding with passed ray queues — documented, not needed by any preset.

Testable without hardware: an 8-device CPU mesh via
``--xla_force_host_platform_device_count=8`` (tests/conftest.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from raytpu.device_scene import DeviceScene, SceneStatic
from raytpu.integrator import RenderStatic


def make_mesh(n_devices: Optional[int] = None, axis: str = "tiles") -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n_devices]), (axis,))


def render_frame_sharded(
    scene: DeviceScene,
    static: SceneStatic,
    rs: RenderStatic,
    camera: jnp.ndarray,
    mesh: Mesh,
) -> jnp.ndarray:
    """Full-frame render sharded across ``mesh`` by whole tile rows.

    Shards the same 32×32 tile-major packet stream the single-chip
    ``render_frame`` traces (``integrator._tiled_pixels``), so every device
    runs the identical hot path — traversal, spp fold, deferred sky — on
    its packet slice with the scene replicated; output is
    bit-identical to the single-device render. The multi-chip analog of one
    ``vkCmdTraceRaysKHR`` dispatch (``src/main.cpp:2620-2624``); the only
    cross-chip data movement is the final tile gather XLA emits for the
    assembled image.
    """
    from raytpu.integrator import PACKET_GRANULE, render_packets
    from raytpu.ops import vec3 as v3

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    # tile-major pixel packets (same construction as integrator's
    # _tiled_pixels), kept as a (tile-row, tile-col) grid so whole TILE ROWS
    # shard: each device's packets form contiguous image row slabs and the
    # detile stays device-local
    t = rs.tile
    k = t * t
    w_t = -(-rs.width // t)
    h_t = -(-rs.height // t)
    h_pad = -(-h_t // n_dev) * n_dev
    ty, tx = jnp.mgrid[0:h_pad, 0:w_t]
    iy, ix = jnp.mgrid[0:t, 0:t]
    xs = (tx.reshape(h_pad, w_t, 1) * t + ix.reshape(1, 1, k)).astype(
        jnp.int32
    )
    ys = (ty.reshape(h_pad, w_t, 1) * t + iy.reshape(1, 1, k)).astype(
        jnp.int32
    )
    in_frame = (xs < rs.width) & (ys < rs.height)
    px = jnp.minimum(xs, rs.width - 1).astype(jnp.float32)
    py = jnp.minimum(ys, rs.height - 1).astype(jnp.float32)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(),
            P(axis, None, None), P(axis, None, None), P(axis, None, None),
        ),
        out_specs=P(axis, None, None),
        check_vma=False,
    )
    def shard_render(scene_rep, camera_rep, pxs, pys, act):
        hl = pxs.shape[0]                      # local tile rows
        p = hl * w_t
        pxf = pxs.reshape(p, k)
        pyf = pys.reshape(p, k)
        actf = act.reshape(p, k)
        # pad the local packet count to the packet granule, as the
        # single-device frame does (padding packets are fully dead)
        pad = (-p) % PACKET_GRANULE
        if pad:
            pxf = jnp.concatenate([pxf, jnp.zeros((pad, k), pxf.dtype)])
            pyf = jnp.concatenate([pyf, jnp.zeros((pad, k), pyf.dtype)])
            actf = jnp.concatenate([actf, jnp.zeros((pad, k), bool)])
        colors = render_packets(
            scene_rep, static, rs, camera_rep, pxf, pyf, actf
        )
        # device-local detile of this shard's tile rows → row slab
        img = (
            v3.to_array(colors)[:p]
            .reshape(hl, w_t, t, t, 3)
            .transpose(0, 2, 1, 3, 4)
            .reshape(hl * t, w_t * t, 3)
        )
        return img[:, : rs.width]

    img = shard_render(scene, camera, px, py, in_frame)
    return img[: rs.height]


@functools.partial(jax.jit, static_argnums=(1, 2), static_argnames=("mesh",))
def _render_sharded_jit(scene, static, rs, camera, *, mesh):
    return render_frame_sharded(scene, static, rs, camera, mesh)


def render_sharded(
    scene: DeviceScene,
    static: SceneStatic,
    rs: RenderStatic,
    camera,
    mesh: Optional[Mesh] = None,
) -> jnp.ndarray:
    """Jitted sharded frame render (mesh defaults to all devices)."""
    if mesh is None:
        mesh = make_mesh()
    return _render_sharded_jit(
        scene, static, rs, jnp.asarray(camera), mesh=mesh
    )

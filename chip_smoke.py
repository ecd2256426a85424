#!/usr/bin/env python
"""Smoke test of the renderer on one GPU: the quickest proof that the
system still starts on the card and renders correctly.

    python chip_smoke.py             # phases 1-5 on one card
    python chip_smoke.py --cards 4   # only the 4-card sharded frame vs 1 card

Phases, in one process that opens the card once:

1. device check — JAX's devices and the card's name and power limit;
   exits non-zero without a GPU (there is no CPU fallback);
2. host set-up — builds ``native/`` and the config4 scene (327,680-triangle
   stand-in + mirror teapot + sea skybox);
3. traversal kernel vs the plain XLA packet walk on config4's full primary
   wave (closest hit and the shadow any-hit it feeds) and on one bounce
   wave, fed identical rays; then the ``gpu``-marked tests;
4. full config4 frames (1920x1080, 4 spp, 3 bounces) through ``Renderer``
   with instance animation and camera steps between frames, as the
   flythrough does;
5. a low-resolution config2 frame against the float64 oracle
   (``tests/oracle_vec.py``).

The last line of output is one JSON object: ``{"ok": ..., "device":
{"platform", "kind", "count"}}``.
"""

import argparse
import json
import os
import sys
import time

# the card or nothing: JAX must not fall back to the CPU
os.environ["JAX_PLATFORMS"] = "cuda"

# tolerances of the kernel-vs-XLA comparison (phase 3). Both walks visit
# the same nodes in the same order with the same Möller–Trumbore
# arithmetic; they differ only where float rounding differs (fused
# multiply-adds, a leaf's box test, NaN handling in the slab test) — a
# grazing ray can then flip between two triangles or hit/miss.
MAX_MISMATCH = 1e-4      # share of lanes whose prim/inst/occlusion differ
T_RTOL = 1e-4            # relative error of t on lanes hitting the same prim
UV_ATOL = 1e-3           # absolute error of u, v on those lanes
# image vs float64 oracle (phase 5): the jitter hash fract(sin(x)·43758)
# turns a one-ulp difference in sin into another sample position, so
# silhouette pixels can differ outright; compare statistics, not bits
IMG_MAE = 0.01           # mean absolute error per channel
IMG_BAD_SHARE = 0.03     # share of pixels off by more than IMG_BAD_DIFF
IMG_BAD_DIFF = 0.05
# sharded vs single card (--cards 4): same program per shard, other shapes
SHARD_MAX_DIFF = 1e-3


def log(msg):
    print(msg, flush=True)


def phase(name):
    log(f"== {name}")


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def device_check():
    import jax

    devs = jax.devices()
    d0 = devs[0]
    log(f"jax.devices(): {devs}")
    log(f"platform={d0.platform} device_kind={d0.device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    if d0.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {d0.platform}")
    from raytpu.bench import gpu_name_and_power_limit

    smi = gpu_name_and_power_limit()
    log(smi)
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}, smi.splitlines()[0]


def host_setup():
    from raytpu.accel import native as native_accel
    from raytpu.bench import build_preset_renderer
    from raytpu.utils import native_lib

    t0 = time.perf_counter()
    native_lib.build()
    log(f"native/ built in {time.perf_counter() - t0:.2f} s")
    check(native_accel.available(), "native library failed to load")
    t0 = time.perf_counter()
    r = build_preset_renderer("config4")
    st = r.static
    log(f"config4 scene + BVH ({'native SAH' if native_accel.available() else 'python SAH'}"
        f" builder): {time.perf_counter() - t0:.2f} s; "
        f"{sum(c for _, c in st.mesh_prim_ranges)} triangles, "
        f"{sum(c for _, c in st.mesh_node_ranges)} nodes, "
        f"traversal={st.traversal}")
    check(st.traversal == "kernel", "the GPU did not resolve to the kernel")
    return r


def compare_closest(name, got, ref):
    import numpy as np

    g_prim, r_prim = np.asarray(got.prim), np.asarray(ref.prim)
    g_inst, r_inst = np.asarray(got.inst), np.asarray(ref.inst)
    lanes = (g_prim >= 0) | (r_prim >= 0)
    diff = (g_prim != r_prim) | (g_inst != r_inst)
    same = (g_prim >= 0) & ~diff
    mism = diff.sum() / max(lanes.sum(), 1)
    t_err = float(np.max(np.abs(np.asarray(got.t)[same] - np.asarray(ref.t)[same])
                         / np.maximum(np.abs(np.asarray(ref.t)[same]), 1e-30),
                         initial=0.0))
    uv_err = max(float(np.max(np.abs(np.asarray(a)[same] - np.asarray(b)[same]),
                              initial=0.0))
                 for a, b in ((got.u, ref.u), (got.v, ref.v)))
    log(f"{name}: {lanes.sum()} hit lanes of {lanes.size}; prim/inst "
        f"mismatch {diff.sum()} ({mism:.2e}); max rel err t {t_err:.2e}; "
        f"max abs err u,v {uv_err:.2e}")
    check(mism <= MAX_MISMATCH, f"{name}: prim/inst mismatch {mism:.2e}")
    check(t_err <= T_RTOL, f"{name}: t error {t_err:.2e}")
    check(uv_err <= UV_ATOL, f"{name}: u,v error {uv_err:.2e}")


def kernel_vs_xla(r):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytpu.config import HIT_EPSILON, RAY_TMAX, RAY_TMIN
    from raytpu.integrator import _tiled_pixels, primary_rays_soa
    from raytpu.ops import shade
    from raytpu.ops import vec3 as v3
    from raytpu.ops.trace import any_hit_wave, closest_hit_wave

    scene, kern = r.device_scene, r.static
    xla = dataclasses.replace(kern, traversal="xla")
    rs = r.render_static
    spp = rs.samples_per_pixel
    (px, py), _, in_frame = _tiled_pixels(rs)
    p = px.shape[0]
    px, py = jnp.repeat(px, spp, axis=0), jnp.repeat(py, spp, axis=0)
    act = jnp.repeat(in_frame, spp, axis=0)
    s_idx = jnp.tile(jnp.arange(spp, dtype=jnp.float32), (p,))[:, None]
    o, d = primary_rays_soa((px, py), jnp.asarray(r.camera.basis()), s_idx,
                            spp, rs.width, rs.height)
    win = jnp.where(act, jnp.float32(RAY_TMAX), 0.0)
    log(f"primary wave: {int(act.sum())} rays ({rs.width}x{rs.height}, "
        f"{spp} spp) in {o[0].shape[0]} packets")

    closest = jax.jit(closest_hit_wave, static_argnums=(1, 4))
    anyhit = jax.jit(any_hit_wave, static_argnums=(1, 4))

    def timed(fn, *a):
        jax.block_until_ready(fn(*a))                    # compile
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a))
        return out, (time.perf_counter() - t0) * 1e3

    hk, ms_k = timed(closest, scene, kern, o, d, RAY_TMIN, win)
    hx, ms_x = timed(closest, scene, xla, o, d, RAY_TMIN, win)
    log(f"closest, primary wave: kernel {ms_k:.2f} ms, XLA walk {ms_x:.2f} ms")
    compare_closest("closest, primary wave", hk, hx)

    # the shadow wave the integrator derives from the primary hits
    # (src/shader.rgen:104-112), from the XLA walk's hits for both walks
    pos = v3.add(o, v3.scale(hx.t, d))
    lit = act & hx.valid & (hx.mat == 0) & (v3.dot(d, hx.n) < 0.0)
    so = v3.add(pos, v3.scale(HIT_EPSILON, hx.n))
    to_l = tuple(scene.light_pos[c] - pos[c] for c in range(3))
    dist = v3.norm(to_l)
    sl = v3.scale(1.0 / jnp.maximum(dist, 1e-30), to_l)
    swin = jnp.where(lit, dist, 0.0)
    ok_, ms_k = timed(anyhit, scene, kern, so, sl, RAY_TMIN, swin)
    ox_, ms_x = timed(anyhit, scene, xla, so, sl, RAY_TMIN, swin)
    occ_k, occ_x = np.asarray(ok_), np.asarray(ox_)
    n_lit = int(np.asarray(lit).sum())
    mism = (occ_k != occ_x).sum() / max(n_lit, 1)
    log(f"any hit, shadow wave: {n_lit} rays, {int(occ_x.sum())} occluded; "
        f"kernel {ms_k:.2f} ms, XLA walk {ms_x:.2f} ms; occlusion mismatch "
        f"{int((occ_k != occ_x).sum())} ({mism:.2e})")
    check(mism <= MAX_MISMATCH, f"occlusion mismatch {mism:.2e}")

    # one bounce wave: mirror reflections of the primary hits
    cont = act & hx.valid & (hx.mat == 1)
    bo, bd = shade.mirror_bounce_soa(d, hx.n, pos)
    bwin = jnp.where(cont, jnp.float32(RAY_TMAX), 0.0)
    bk, ms_k = timed(closest, scene, kern, bo, bd, RAY_TMIN, bwin)
    bx, ms_x = timed(closest, scene, xla, bo, bd, RAY_TMIN, bwin)
    log(f"closest, bounce wave: {int(np.asarray(cont).sum())} rays; kernel "
        f"{ms_k:.2f} ms, XLA walk {ms_x:.2f} ms")
    compare_closest("closest, bounce wave", bk, bx)


def gpu_tests():
    import pytest

    import tests

    root = os.path.dirname(os.path.abspath(__file__))
    check(os.path.dirname(tests.__file__) == os.path.join(root, "tests"),
          f"`tests` resolves to {tests.__file__}, not this repository's")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", "-p", "no:randomly",
                      os.path.join(root, "tests")])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {int(rc)})")


def full_frames(r, smi, n_frames=6):
    import jax
    import numpy as np

    from raytpu.camera import MoveDirection
    from raytpu.config import RAY_TMAX, RAY_TMIN
    from raytpu.integrator import primary_rays
    from raytpu.ops.trace import closest_hit_wave

    rs = r.render_static
    cam = r.camera
    # primary-hit share of a frame at 1 spp: "not all sky"
    ys, xs = np.mgrid[0:rs.height:8, 0:rs.width:8]
    pix = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)

    @jax.jit
    def hit_share(scene, basis):
        o, d = primary_rays(pix, basis, jax.numpy.float32(0.0), 1,
                            rs.width, rs.height)
        h = closest_hit_wave(scene, r.static, tuple(o.T[:, None]),
                             tuple(d.T[:, None]), RAY_TMIN,
                             jax.numpy.float32(RAY_TMAX))
        return h.valid.mean()

    t0 = time.perf_counter()
    jax.block_until_ready(r.render())
    compile_s = time.perf_counter() - t0
    times = []
    t_param = 0.0
    for i in range(n_frames):
        t_param += 0.1 / 60.0
        cam.move(MoveDirection.FORWARD, 0.5)
        cam.process_mouse_movement(0.02, 0.005)
        r.set_transforms(t_param)
        t0 = time.perf_counter()
        img = jax.block_until_ready(r.render())
        times.append((time.perf_counter() - t0) * 1e3)
        img = np.asarray(img)
        share = float(hit_share(r.device_scene, jax.numpy.asarray(cam.basis())))
        check(img.shape == (rs.height, rs.width, 3), f"frame {i} shape")
        check(np.isfinite(img).all(), f"frame {i} not finite")
        check(share > 0.01, f"frame {i} is all sky (hit share {share:.3f})")
        log(f"frame {i}: {times[-1]:.2f} ms, mean {img.mean():.4f}, "
            f"primary hit share {share:.3f}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"config4 {rs.width}x{rs.height} {rs.samples_per_pixel} spp "
        f"{rs.max_bounce_count} bounces: steady frame {steady:.2f} ms "
        f"(median of {len(times) - 1}), compile {compile_s:.1f} s "
        f"[{smi}]")


def image_vs_oracle():
    import jax.numpy as jnp
    import numpy as np

    from raytpu.ops.sky import sample_cubemap
    from raytpu.presets import PRESETS, load_preset_scene
    from raytpu.render import Renderer
    from tests import oracle_vec

    w, h, spp, bounces = 128, 96, 4, 2
    cfg = PRESETS["config2"]().replace(width=w, height=h,
                                       samples_per_pixel=spp,
                                       max_bounce_count=bounces)
    scene = load_preset_scene(cfg)
    r = Renderer(scene)
    r.set_transforms(0.0)
    img = r.render_np()

    anim = scene.animation()
    anim.step(0.0)
    instances = []
    for i, (mesh, inst) in enumerate(zip(scene.meshes, scene.instances)):
        m4 = np.eye(4)
        m4[:3] = anim.transforms_3x4()[i]
        instances.append(dict(
            verts=mesh.positions.astype(float),
            normals=mesh.normals.astype(float), tris=mesh.triangles,
            material=int(inst.material), o2w=m4, w2o=np.linalg.inv(m4)))
    # the texels the renderer samples: the sky quantized to 8 bits
    sky8 = jnp.asarray(np.floor(scene.skybox * 255.0 + 0.5) / 255.0,
                       jnp.float32)

    def sky_fn(dirs):
        return np.asarray(sample_cubemap(sky8, jnp.asarray(dirs, jnp.float32)),
                          float)

    vs = oracle_vec.VecScene(instances, cfg.light_position,
                             cfg.light_intensity, sky_fn)
    b = r.camera.basis().astype(float)
    ref = oracle_vec.render(vs, (b[0], b[1], b[2], b[3]), w, h, spp, bounces)
    err = np.abs(img - ref)
    mae = float(err.mean())
    bad = float((err.max(axis=-1) > IMG_BAD_DIFF).mean())
    log(f"config2 {w}x{h} {spp} spp vs float64 oracle: mean abs err "
        f"{mae:.2e} (limit {IMG_MAE}), pixels off by > {IMG_BAD_DIFF}: "
        f"{bad:.2%} (limit {IMG_BAD_SHARE:.0%})")
    check(mae <= IMG_MAE and bad <= IMG_BAD_SHARE, "image differs from oracle")


def sharded_vs_single(n_cards):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytpu.bench import build_preset_renderer
    from raytpu.integrator import render_frame
    from raytpu.parallel import make_mesh, render_sharded

    check(len(jax.devices()) >= n_cards, f"need {n_cards} cards")
    r = build_preset_renderer("config4")
    cam = jnp.asarray(r.camera.basis())
    mesh = make_mesh(n_cards)
    single = np.asarray(render_frame(r.device_scene, r.static,
                                     r.render_static, cam))
    sharded = render_sharded(r.device_scene, r.static, r.render_static, cam,
                             mesh)
    jax.block_until_ready(sharded)
    t = {}
    for name, fn in (
        ("1 card", lambda: render_frame(r.device_scene, r.static,
                                        r.render_static, cam)),
        (f"{n_cards} cards", lambda: render_sharded(
            r.device_scene, r.static, r.render_static, cam, mesh)),
    ):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times.append((time.perf_counter() - t0) * 1e3)
        t[name] = sorted(times)[1]
    sharded = np.asarray(sharded)
    diff = np.abs(sharded - single)
    log(f"config4 sharded over {mesh.devices.size} cards vs 1 card: "
        f"max abs diff {diff.max():.2e}, pixels differing "
        f"{(diff.max(-1) > 0).mean():.2e}; median frame "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in t.items()))
    check(sharded.shape == single.shape, "sharded frame shape")
    check(float(diff.max()) <= SHARD_MAX_DIFF, "sharded frame differs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the sharded frame over 4 cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    phase("1. device check")
    device, smi = device_check()
    from raytpu.utils.cache import enable_compilation_cache

    log(f"compile cache: {enable_compilation_cache()}")
    ok = False
    try:
        if args.cards > 1:
            phase(f"6. sharded frame over {args.cards} cards vs one card")
            sharded_vs_single(args.cards)
        else:
            phase("2. host set-up")
            r = host_setup()
            phase("3. traversal kernel vs XLA packet walk (config4 widths)")
            kernel_vs_xla(r)
            gpu_tests()
            phase("4. full config4 frames")
            full_frames(r, smi)
            del r
            phase("5. low-resolution image vs float64 oracle")
            image_vs_oracle()
        ok = True
    finally:
        print(json.dumps({"ok": ok, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

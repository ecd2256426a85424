"""Procedural stand-ins for the reference's scene assets.

The reference ships its meshes and skyboxes as files (SURVEY.md C25); this
repository generates stand-ins of the same shapes instead, so every preset
runs from the repository alone. Presets name them with ``generated://``
paths (``load_mesh`` / ``load_skybox``); an explicit resource directory
still loads real files.

* ``armadillo`` — the reference's default orbiting mesh is a missing blob
  even upstream. A subdivided icosphere displaced by a sum of
  incommensurate sinusoids: ~327k triangles at depth 7, bumpy enough that
  the BVH is non-trivial and normals vary per vertex.
* ``cube`` — 24 vertices / 12 faces with flat normals, extent ±1, like
  ``cube.obj``.
* ``teapot`` — a curved, closed surface of revolution of the teapot's size
  (about 1.2k vertices / 2.3k faces, a bulging body, a lid knob and a
  one-sided spout bulge so the spin animation shows).
* ``cube_scene`` — a Cornell-box-like open room (five walls, a ceiling
  light, two blocks and a pyramid; 45 vertices / 42 faces) like
  ``cube_scene.obj``.
* ``skybox_sea`` — six cube faces of a seeded procedural sky over a sea
  (horizon gradient, clouds from random plane waves, a sun), computed as a
  function of direction so the faces meet without seams.
"""

from __future__ import annotations

import numpy as np

from raytpu.io.obj import Mesh, compute_smooth_normals, load_obj

GENERATED = "generated://"


def icosahedron():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return v, f


def subdivide(v: np.ndarray, f: np.ndarray):
    """One loop of midpoint subdivision on the unit sphere (vectorized)."""
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    edges_sorted = np.sort(edges, axis=1)
    uniq, inv = np.unique(edges_sorted, axis=0, return_inverse=True)
    mid = v[uniq[:, 0]] + v[uniq[:, 1]]
    mid /= np.linalg.norm(mid, axis=1, keepdims=True)
    mid_idx = len(v) + np.arange(len(uniq))
    new_v = np.concatenate([v, mid], axis=0)

    n = len(f)
    m01 = mid_idx[inv[0:n]]
    m12 = mid_idx[inv[n : 2 * n]]
    m20 = mid_idx[inv[2 * n : 3 * n]]
    new_f = np.concatenate(
        [
            np.stack([f[:, 0], m01, m20], axis=1),
            np.stack([f[:, 1], m12, m01], axis=1),
            np.stack([f[:, 2], m20, m12], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ],
        axis=0,
    )
    return new_v, new_f


def displacement(v: np.ndarray, amplitude: float = 0.18) -> np.ndarray:
    """Deterministic bumpy radial displacement (sum of incommensurate
    sinusoids — enough spatial frequency content to make the BVH earn its
    keep on config 4)."""
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    d = (
        np.sin(7.1 * x + 1.3) * np.sin(6.3 * y + 0.7) * np.sin(5.7 * z + 2.1)
        + 0.5 * np.sin(13.7 * x) * np.sin(11.9 * y + 1.1)
        + 0.25 * np.sin(23.3 * z + 0.5) * np.sin(19.1 * x + 2.9)
    )
    return 1.0 + amplitude * d / 1.75


def generate_highpoly(depth: int = 7, radius: float = 1.0,
                      name: str = "armadillo_standin") -> Mesh:
    """~20·4^depth triangles (depth 7 → 327,680; armadillo-class)."""
    v, f = icosahedron()
    for _ in range(depth):
        v, f = subdivide(v, f)
    r = displacement(v)
    pos = (v * (r * radius)[:, None]).astype(np.float32)
    tris = f.astype(np.int32)
    normals = compute_smooth_normals(pos, tris)
    mesh = Mesh(positions=pos, normals=normals, triangles=tris, name=name)
    mesh.validate()
    return mesh


_STANDIN_CACHE = {}


def armadillo_standin(scale: float = 1.0, depth: int = 7) -> Mesh:
    """The config-4 stand-in, scaled to roughly unit size like the
    reference meshes (cube extent ±1, teapot ~±3).

    Cached per (scale, depth): the 327k-triangle generation costs tens of
    seconds and several presets (config4, reference) share the mesh in one
    benchmark process."""
    key = (float(scale), int(depth))
    if key not in _STANDIN_CACHE:
        _STANDIN_CACHE[key] = generate_highpoly(depth=depth, radius=scale)
    return _STANDIN_CACHE[key]


def cube() -> Mesh:
    """Unit cube, extent ±1: four vertices per face so normals stay flat."""
    pos, nrm, tris = [], [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3)
            n[axis] = sign
            u = np.roll(n, 1) * sign          # in-plane axes, right-handed
            v = np.cross(n, u)
            base = len(pos)
            for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                pos.append(n + a * u + b * v)
                nrm.append(n)
            tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    mesh = Mesh(positions=np.asarray(pos, np.float32),
                normals=np.asarray(nrm, np.float32),
                triangles=np.asarray(tris, np.int32), name="cube")
    mesh.validate()
    return mesh


def teapot(rings: int = 25, segments: int = 48) -> Mesh:
    """Closed teapot-sized surface of revolution about +Y: ``(rings - 1) *
    segments + 2`` vertices, ``2 * segments * (rings - 1)`` faces (1,154 /
    2,304 at the defaults), about 6 wide and 3 tall like ``teapot.obj``."""
    s = np.linspace(0.0, 1.0, rings + 1)[1:-1]          # ring heights
    phi = np.linspace(0.0, 2 * np.pi, segments, endpoint=False)
    # body profile: a squat bulge with a narrower lid and a knob on top
    radius = (2.0 * np.sin(np.pi * s) ** 0.7 * (1.0 + 0.12 * np.sin(2 * np.pi * s))
              + 0.35 * np.exp(-((s - 0.93) / 0.04) ** 2))
    height = 3.0 * s
    # spout side (+X) bulges out, handle side stays round
    bulge = 1.0 + 0.25 * np.maximum(np.cos(phi), 0.0) ** 6
    r = radius[:, None] * bulge[None, :]
    ring_pts = np.stack(
        [r * np.cos(phi)[None, :], np.broadcast_to(height[:, None], r.shape),
         r * np.sin(phi)[None, :]], axis=-1).reshape(-1, 3)
    pos = np.concatenate([[[0.0, 0.0, 0.0]], ring_pts, [[0.0, 3.0, 0.0]]])
    n_ring = rings - 1
    idx = 1 + np.arange(n_ring * segments).reshape(n_ring, segments)
    nxt = np.roll(idx, -1, axis=1)
    tris = [np.stack([np.zeros(segments, np.int64), nxt[0], idx[0]], 1)]
    a, b = idx[:-1], nxt[:-1]
    c, d = idx[1:], nxt[1:]
    tris.append(np.stack([a, b, d], -1).reshape(-1, 3))
    tris.append(np.stack([a, d, c], -1).reshape(-1, 3))
    top = len(pos) - 1
    tris.append(np.stack([idx[-1], nxt[-1], np.full(segments, top)], 1))
    tris = np.concatenate(tris).astype(np.int32)
    pos = pos.astype(np.float32)
    mesh = Mesh(positions=pos, normals=compute_smooth_normals(pos, tris),
                triangles=tris, name="teapot")
    mesh.validate()
    return mesh


def _box(lo, hi):
    """Closed box: 8 shared corners, 12 faces."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    c = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                  for z in (lo[2], hi[2])])
    f = [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]
    return c, f


def cube_scene() -> Mesh:
    """Cornell-box-like room open toward +Z: floor, ceiling, back and side
    walls (separate quads), a ceiling light quad, a tall and a short block,
    and a pyramid — eight objects in one soup, 45 vertices / 42 faces."""
    h = 2.0
    quads = [
        [(-h, -h, -h), (h, -h, -h), (h, -h, h), (-h, -h, h)],      # floor
        [(-h, h, -h), (-h, h, h), (h, h, h), (h, h, -h)],          # ceiling
        [(-h, -h, -h), (-h, h, -h), (h, h, -h), (h, -h, -h)],      # back
        [(-h, -h, -h), (-h, -h, h), (-h, h, h), (-h, h, -h)],      # left
        [(h, -h, -h), (h, h, -h), (h, h, h), (h, -h, h)],          # right
        [(-0.5, h - 0.01, -0.5), (-0.5, h - 0.01, 0.5),
         (0.5, h - 0.01, 0.5), (0.5, h - 0.01, -0.5)],              # light
    ]
    pos, tris = [], []
    for q in quads:
        b = len(pos)
        pos += list(q)
        tris += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
    for lo, hi in (((-1.5, -h, -1.2), (-0.4, 0.4, -0.1)),
                   ((0.3, -h, -0.2), (1.4, -1.0, 0.9))):
        c, f = _box(lo, hi)
        b = len(pos)
        pos += [tuple(p) for p in c]
        tris += [[b + i for i in t] for t in f]
    b = len(pos)
    pos += [(-0.6, -h, 1.0), (0.2, -h, 1.0), (0.2, -h, 1.8), (-0.6, -h, 1.8),
            (-0.2, -h + 1.0, 1.4)]
    tris += [[b, b + 2, b + 1], [b, b + 3, b + 2], [b, b + 1, b + 4],
             [b + 1, b + 2, b + 4], [b + 2, b + 3, b + 4], [b + 3, b, b + 4]]
    pos = np.asarray(pos, np.float32)
    tris = np.asarray(tris, np.int32)
    mesh = Mesh(positions=pos, normals=compute_smooth_normals(pos, tris),
                triangles=tris, name="cube_scene")
    mesh.validate()
    return mesh


def _face_directions(face: int, size: int) -> np.ndarray:
    """Unit directions through the texel centres of one cube face, in the
    layer order +X, -X, +Y, -Y, +Z, -Z and the (s, t) orientation that
    ``ops/sky.cube_face_st`` samples with."""
    c = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    sc, tc = np.meshgrid(c, c)               # sc along columns, tc along rows
    one = np.ones_like(sc)
    d = {
        0: (one, -tc, -sc), 1: (-one, -tc, sc),
        2: (sc, one, tc), 3: (sc, -one, -tc),
        4: (sc, -tc, one), 5: (-sc, -tc, -one),
    }[face]
    d = np.stack(d, axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def skybox_sea(size: int = 2048, seed: int = 0) -> np.ndarray:
    """Seeded procedural sea-and-sky cube map → (6, size, size, 3) float32
    in [0, 1]."""
    rng = np.random.default_rng(seed)
    waves = rng.normal(size=(8, 3)).astype(np.float32)
    waves *= (rng.uniform(3.0, 9.0, size=(8, 1)) /
              np.linalg.norm(waves, axis=1, keepdims=True)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, size=8).astype(np.float32)
    sun = np.asarray([0.4, 0.35, -0.85], np.float32)
    sun /= np.linalg.norm(sun)
    zenith = np.asarray([0.25, 0.45, 0.85], np.float32)
    horizon = np.asarray([0.80, 0.88, 0.95], np.float32)
    deep = np.asarray([0.02, 0.12, 0.25], np.float32)
    shallow = np.asarray([0.10, 0.35, 0.45], np.float32)
    faces = np.empty((6, size, size, 3), np.float32)
    for f in range(6):
        d = _face_directions(f, size)
        y = d[..., 1:2]
        up = np.clip(y, 0.0, 1.0) ** 0.5
        sky = horizon + (zenith - horizon) * up
        noise = np.sin(d @ waves.T + phases).mean(axis=-1, keepdims=True)
        cloud = np.clip(noise * 2.5, 0.0, 1.0) * (y > 0.02)
        sky = sky + (1.0 - sky) * 0.8 * cloud
        sun_glow = np.clip(d @ sun, 0.0, 1.0)[..., None] ** 256
        sky = sky + sun_glow * np.asarray([1.0, 0.9, 0.6], np.float32)
        sea_t = np.clip(-y, 0.0, 1.0) ** 0.4
        sea = shallow + (deep - shallow) * sea_t + 0.03 * noise
        faces[f] = np.clip(np.where(y >= 0.0, sky, sea), 0.0, 1.0)
    return faces


_MESHES = {
    "cube": cube,
    "teapot": teapot,
    "cube_scene": cube_scene,
}
_SKYBOXES = {"skybox_sea": skybox_sea}
# generated cube maps per (name, size): several presets share one sky in a
# benchmark process, and a 2048² map takes seconds to generate
_SKYBOX_CACHE = {}


def is_generated(path: str) -> bool:
    return path.startswith(GENERATED)


def load_mesh(path: str, highpoly_depth: int = 7) -> Mesh:
    """A mesh by path: ``generated://<name>`` or an OBJ file."""
    if not is_generated(path):
        return load_obj(path)
    name = path[len(GENERATED):]
    if name == "armadillo":
        return armadillo_standin(depth=highpoly_depth)
    if name not in _MESHES:
        raise KeyError(f"unknown generated mesh {name!r}; "
                       f"available: {sorted(_MESHES) + ['armadillo']}")
    return _MESHES[name]()


def load_skybox(path: str, size: int = 2048) -> np.ndarray:
    """A cube map by path: ``generated://<name>`` (faces of ``size``²) or a
    directory of six face images."""
    if not is_generated(path):
        from raytpu.io.image import load_skybox as load_files

        return load_files(path)
    name = path[len(GENERATED):]
    if name not in _SKYBOXES:
        raise KeyError(f"unknown generated skybox {name!r}; "
                       f"available: {sorted(_SKYBOXES)}")
    if (name, size) not in _SKYBOX_CACHE:
        _SKYBOX_CACHE[(name, size)] = _SKYBOXES[name](size)
    return _SKYBOX_CACHE[(name, size)]

"""OBJ ingestion tests (reference semantics: src/main.cpp:51-63,1603-1729)."""

import numpy as np
import pytest

from raytpu.io.obj import Mesh, compute_smooth_normals, load_obj_numpy
from raytpu.scene import assemble_geometry


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_parse_v_vn_f_double_slash(tmp_path):
    path = _write(
        tmp_path,
        "tri.obj",
        """
v 0 0 0
v 1 0 0
v 0 1 0
vn 0 0 1
vn 0 0 1
vn 0 0 1
f 1//1 2//2 3//3
""",
    )
    m = load_obj_numpy(path)
    assert m.num_vertices == 3 and m.num_triangles == 1
    np.testing.assert_allclose(m.normals, [[0, 0, 1]] * 3)
    np.testing.assert_array_equal(m.triangles, [[0, 1, 2]])


def test_fan_triangulation_quad(tmp_path):
    path = _write(
        tmp_path,
        "quad.obj",
        """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
""",
    )
    m = load_obj_numpy(path)
    assert m.num_triangles == 2
    np.testing.assert_array_equal(m.triangles, [[0, 1, 2], [0, 2, 3]])


def test_negative_indices(tmp_path):
    path = _write(
        tmp_path,
        "neg.obj",
        """
v 0 0 0
v 1 0 0
v 0 1 0
f -3 -2 -1
""",
    )
    m = load_obj_numpy(path)
    np.testing.assert_array_equal(m.triangles, [[0, 1, 2]])


def test_missing_normals_computed_smooth(tmp_path):
    path = _write(
        tmp_path,
        "nonorm.obj",
        """
v 0 0 0
v 1 0 0
v 0 1 0
f 1 2 3
""",
    )
    m = load_obj_numpy(path)
    np.testing.assert_allclose(m.normals, [[0, 0, 1]] * 3, atol=1e-6)


def test_smooth_normals_unit_length():
    pos = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float32
    )
    tris = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], dtype=np.int32)
    n = compute_smooth_normals(pos, tris)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)


def test_reference_cube(resources_dir):
    # cube.obj stand-in: 24 duplicated vertices, 12 faces, like the
    # reference's resources/cube.obj:1-2
    m = load_obj_numpy(f"{resources_dir}/cube.obj")
    assert m.num_vertices == 24
    assert m.num_triangles == 12
    lo, hi = m.aabb()
    np.testing.assert_allclose(lo, [-1, -1, -1])
    np.testing.assert_allclose(hi, [1, 1, 1])
    # position-aligned vn list → exact reference normal indexing
    np.testing.assert_allclose(np.linalg.norm(m.normals, axis=1), 1.0, atol=1e-6)


def test_reference_teapot(resources_dir):
    # the stand-in: a closed surface of revolution (the reference's teapot
    # has 1202 v / 2256 f)
    m = load_obj_numpy(f"{resources_dir}/teapot.obj")
    assert m.num_vertices == 1154
    assert m.num_triangles == 2304
    m.validate()
    # closed: every edge is shared by exactly two faces
    e = np.sort(np.concatenate([m.triangles[:, [0, 1]], m.triangles[:, [1, 2]],
                                m.triangles[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()


def test_reference_cube_scene(resources_dir):
    # one soup of several objects (src/main.cpp:1640-1654 concat); the
    # stand-in has 45 v / 42 f (the reference's cube_scene 44 v / 42 f)
    m = load_obj_numpy(f"{resources_dir}/cube_scene.obj")
    assert (m.num_vertices, m.num_triangles) == (45, 42)
    m.validate()


def test_assemble_geometry_offsets(tmp_path):
    a = Mesh(
        positions=np.zeros((3, 3), np.float32),
        normals=np.zeros((3, 3), np.float32),
        triangles=np.array([[0, 1, 2]], np.int32),
        name="a",
    )
    b = Mesh(
        positions=np.ones((4, 3), np.float32),
        normals=np.zeros((4, 3), np.float32),
        triangles=np.array([[0, 1, 2], [1, 2, 3]], np.int32),
        name="b",
    )
    g = assemble_geometry([a, b])
    # offsets mirror orbitingObjectPrimitiveOffset / VertexOffset
    # (src/main.cpp:1872-1873)
    assert g.vertex_offsets == (0, 3)
    assert g.primitive_offsets == (0, 1)
    # rebased indices point into the flat arrays
    np.testing.assert_array_equal(g.triangles, [[0, 1, 2], [3, 4, 5], [4, 5, 6]])
    vs, ps = g.mesh_slice(1)
    assert (vs.start, vs.stop) == (3, 7)
    assert (ps.start, ps.stop) == (1, 3)


def test_mtl_parsed_but_unused(resources_dir):
    """MTL parity quirk: materials are parsed (like tinyobjloader in the
    reference) but shading ignores them (src/main.cpp:1648)."""
    m = load_obj_numpy(f"{resources_dir}/cube_scene.obj")
    assert m.materials_info, "cube_scene.mtl should have been parsed"
    any_mat = next(iter(m.materials_info.values()))
    assert "Kd" in any_mat or "Ns" in any_mat


def test_parse_mtl_direct(tmp_path):
    from raytpu.io.obj import parse_mtl

    p = tmp_path / "m.mtl"
    p.write_text("newmtl red\nKd 1 0 0\nNs 50\nmap_Kd tex.png\n")
    mats = parse_mtl(str(p))
    assert mats["red"]["Kd"] == [1.0, 0.0, 0.0]
    assert mats["red"]["Ns"] == 50.0
    assert mats["red"]["map_Kd"] == "tex.png"
    assert parse_mtl(str(tmp_path / "missing.mtl")) == {}

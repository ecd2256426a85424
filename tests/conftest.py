"""Test harness configuration.

Tests run on the CPU with 8 virtual devices, so the multi-device sharding
path is exercised without a GPU (the domain's "multi-node without a
cluster" answer — see SURVEY.md §4). The pin must happen before the first
`import jax`; it applies unless the caller chose another platform
(``chip_smoke.py`` runs the ``gpu``-marked tests on the card with
``JAX_PLATFORMS=cuda``).

Scene assets come from the in-repo procedural stand-ins
(``raytpu/io/genmesh.py``); ``resources_dir`` writes them out as files laid
out like the reference's ``resources/`` for the tests that exercise the
OBJ and JPEG parsers.
"""

import os

if os.environ.get("JAX_PLATFORMS", "") in ("", "cpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_platforms", "cpu")

SKYBOX_SIZE = 2048  # the reference's face size


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked ``gpu`` need the card; they skip anywhere else."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card by chip_smoke.py")


@pytest.fixture(scope="session")
def resources_dir(tmp_path_factory):
    """The stand-in assets written as files: ``cube.obj``, ``teapot.obj``,
    ``cube_scene.obj`` (+ ``cube_scene.mtl``) and the six JPEG faces of
    ``skybox_texture_sea``."""
    from PIL import Image

    from raytpu.io import genmesh
    from raytpu.io.obj import write_obj

    root = tmp_path_factory.mktemp("resources")
    write_obj(str(root / "cube.obj"), genmesh.cube())
    write_obj(str(root / "teapot.obj"), genmesh.teapot())
    write_obj(str(root / "cube_scene.obj"), genmesh.cube_scene(),
              mtllib="cube_scene.mtl")
    (root / "cube_scene.mtl").write_text(
        "newmtl wall\nKd 0.8 0.8 0.8\nNs 10\n"
        "newmtl light\nKd 1 1 1\nKe 1 1 1\n"
    )
    from raytpu.io.image import SKYBOX_FACE_FILES

    sky_dir = root / "skybox_texture_sea"
    sky_dir.mkdir()
    faces = genmesh.skybox_sea(SKYBOX_SIZE)
    for name, face in zip(SKYBOX_FACE_FILES, faces):
        img = (np.clip(face, 0, 1) * 255 + 0.5).astype(np.uint8)
        Image.fromarray(img).save(str(sky_dir / name), quality=92)
    return str(root)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)

"""Scene presets: the reference default + the five BASELINE benchmark configs.

BASELINE.json / BASELINE.md define the benchmark matrix; each preset returns
a fully-specified :class:`RenderConfig`. Assets are the in-repo procedural
stand-ins (``raytpu/io/genmesh.py``) unless ``resource_dir`` names a
directory laid out like the reference's ``resources/``.
"""

from __future__ import annotations

from typing import Optional

from raytpu.config import MaterialType, ObjectConfig, RenderConfig
from raytpu.io.genmesh import GENERATED
from raytpu.scene import Scene, load_scene

# asset name → file or directory under a reference-style resource dir
_FILES = {
    "cube": "cube.obj",
    "teapot": "teapot.obj",
    "cube_scene": "cube_scene.obj",
    "skybox_sea": "skybox_texture_sea",
}


def _asset(resource_dir: Optional[str], name: str) -> str:
    if resource_dir:
        return f"{resource_dir}/{_FILES[name]}"
    return GENERATED + name


def config1_cube(resource_dir: Optional[str] = None) -> RenderConfig:
    """BASELINE config 1: cube.obj, primary rays + hard shadows, static
    camera, 512×512 (CPU-checkable golden)."""
    return RenderConfig(
        objects=(ObjectConfig(_asset(resource_dir, "cube"),
                              MaterialType.DIFFUSE, "static"),),
        skybox_dir=None,
        width=512,
        height=512,
        samples_per_pixel=1,
        max_bounce_count=0,  # primary + shadow only
    )


def config2_teapot_mirror(resource_dir: Optional[str] = None) -> RenderConfig:
    """BASELINE config 2: teapot mirror + sea skybox, 2-bounce, 800×600."""
    return RenderConfig(
        objects=(ObjectConfig(_asset(resource_dir, "teapot"),
                              MaterialType.MIRROR, "static"),),
        skybox_dir=_asset(resource_dir, "skybox_sea"),
        width=800,
        height=600,
        samples_per_pixel=4,
        max_bounce_count=2,
    )


def config3_refract(resource_dir: Optional[str] = None) -> RenderConfig:
    """BASELINE config 3: cube_scene.obj refractive glass (Snell + TIR),
    3-bounce, 1280×720."""
    return RenderConfig(
        objects=(
            ObjectConfig(_asset(resource_dir, "cube_scene"),
                         MaterialType.REFRACTIVE, "static"),
        ),
        skybox_dir=_asset(resource_dir, "skybox_sea"),
        width=1280,
        height=720,
        samples_per_pixel=4,
        max_bounce_count=3,
    )


def config4_highpoly(resource_dir: Optional[str] = None) -> RenderConfig:
    """BASELINE config 4: armadillo-class high-poly mesh — BVH build quality
    + divergent traversal stress, 3-bounce, 1920×1080.

    ``armadillo.obj`` is a missing blob; the generated stand-in is used
    (``raytpu/io/genmesh.py``). The mirror teapot stays as the center mesh
    like the reference default (``include/config.h:6-16``)."""
    return RenderConfig(
        objects=(
            ObjectConfig(_asset(resource_dir, "teapot"),
                         MaterialType.MIRROR, "spin"),
            ObjectConfig(GENERATED + "armadillo", MaterialType.DIFFUSE,
                         "orbit"),
        ),
        skybox_dir=_asset(resource_dir, "skybox_sea"),
        width=1920,
        height=1080,
        samples_per_pixel=4,
        max_bounce_count=3,
    )


def config5_flythrough(resource_dir: Optional[str] = None) -> RenderConfig:
    """BASELINE config 5: interactive flythrough — mixed reflect/refract
    scene, per-frame re-trace, 60 FPS target, 1920×1080."""
    return RenderConfig(
        objects=(
            ObjectConfig(_asset(resource_dir, "teapot"),
                         MaterialType.MIRROR, "spin"),
            ObjectConfig(_asset(resource_dir, "cube"),
                         MaterialType.REFRACTIVE, "orbit"),
        ),
        skybox_dir=_asset(resource_dir, "skybox_sea"),
        width=1920,
        height=1080,
        samples_per_pixel=1,
        max_bounce_count=3,
    )


PRESETS = {
    "config1": config1_cube,
    "config2": config2_teapot_mirror,
    "config3": config3_refract,
    "config4": config4_highpoly,
    "config5": config5_flythrough,
    "reference": None,  # filled below
}


def reference_scene(resource_dir: Optional[str] = None) -> RenderConfig:
    """The reference's shipped compile-time default (``include/config.h``):
    mirror teapot center + diffuse armadillo(-standin) orbiting, sea skybox,
    800×600, 4 spp, 63 bounces."""
    return RenderConfig(
        objects=(
            ObjectConfig(_asset(resource_dir, "teapot"),
                         MaterialType.MIRROR, "spin"),
            ObjectConfig(GENERATED + "armadillo", MaterialType.DIFFUSE,
                         "orbit"),
        ),
        skybox_dir=_asset(resource_dir, "skybox_sea"),
        width=800,
        height=600,
        samples_per_pixel=4,
        max_bounce_count=63,
    )


PRESETS["reference"] = reference_scene


def load_preset_scene(name_or_config, highpoly_depth: int = 7) -> Scene:
    """Resolve a preset name (or a RenderConfig) into a loaded Scene,
    materializing ``generated://`` assets."""
    if isinstance(name_or_config, str):
        if name_or_config not in PRESETS:
            raise KeyError(
                f"unknown preset {name_or_config!r}; available: {sorted(PRESETS)}"
            )
        config = PRESETS[name_or_config]()
    else:
        config = name_or_config
    return load_scene(config, highpoly_depth=highpoly_depth)

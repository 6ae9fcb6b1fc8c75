from sunray_tpu_torch.scene.procedural import cornell_box
from sunray_tpu_torch.scene.types import (
    MaterialTable,
    SceneBuffers,
    TextureAtlas,
    build_scene,
)

__all__ = [
    "MaterialTable", "SceneBuffers", "TextureAtlas", "build_scene",
    "cornell_box",
]

from sunray_tpu_torch.scene.procedural import (
    cornell_box,
    cornell_box_many_lights,
    reflection_room,
)
from sunray_tpu_torch.scene.types import (
    ALPHA_BLEND,
    ALPHA_MASK,
    ALPHA_OPAQUE,
    NULL_TEXTURE,
    MaterialTable,
    SceneBuffers,
    TextureAtlas,
    build_scene,
)

__all__ = [
    "MaterialTable", "SceneBuffers", "TextureAtlas", "build_scene",
    "cornell_box", "cornell_box_many_lights", "reflection_room",
    "ALPHA_OPAQUE", "ALPHA_MASK",
    "ALPHA_BLEND", "NULL_TEXTURE",
]

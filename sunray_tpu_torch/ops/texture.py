"""Texture sampling — only the trivial-atlas short-circuit of
sunray_tpu/ops/texture.py:44-46.

A textureless scene carries the static 1x1x1 atlas, for which every lookup
is the fallback (NULL texture) or the white dummy texel. Any other atlas
raises: full atlas sampling is not ported yet.
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.scene.types import NULL_TEXTURE


def sample_texture(atlas, tex_id, fallback):
    """tex_id: (N,) int32; fallback: (N, 4). Returns (N, 4).

    The uv argument of the JAX function is dead for the trivial atlas and
    is left out."""
    if not atlas.trivial:
        raise NotImplementedError(
            "textured atlases are not ported yet (trivial 1x1x1 atlas only)"
        )
    is_null = tex_id == NULL_TEXTURE
    return torch.where(is_null[:, None], fallback, torch.ones_like(fallback))

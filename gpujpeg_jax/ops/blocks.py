"""Plane <-> 8x8 block layout conversions (backend-generic)."""
from __future__ import annotations


def plane_to_blocks(plane, xp):
    """(H, W) -> (H/8*W/8, 64); blocks in raster order, pixels in natural
    (row-major) order within each block."""
    h, w = plane.shape
    assert h % 8 == 0 and w % 8 == 0, (h, w)
    return (plane.reshape(h // 8, 8, w // 8, 8)
                 .transpose(0, 2, 1, 3)
                 .reshape(h // 8 * (w // 8), 64))


def blocks_to_plane(blocks, h: int, w: int, xp):
    """(H/8*W/8, 64) -> (H, W)."""
    return (blocks.reshape(h // 8, w // 8, 8, 8)
                  .transpose(0, 2, 1, 3)
                  .reshape(h, w))

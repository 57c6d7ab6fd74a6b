"""Canvas tile layouts.

Tiles are (N, T, T, 4) channel-interleaved RGBA.  The serving API and the
whole-plan program keep them channel-planar, (N, T, 4T): each tile row
holds the T red values, then green, blue and alpha.  Both helpers are
plain reshapes/transposes.
"""

from __future__ import annotations


def to_planar(tiles):
    """(N, T, T, 4) -> channel-planar (N, T, 4T)."""
    n, t = tiles.shape[0], tiles.shape[1]
    return tiles.transpose(0, 1, 3, 2).reshape(n, t, 4 * t)


def from_planar(canvas):
    """Channel-planar (N, T, 4T) -> (N, T, T, 4)."""
    n, t = canvas.shape[0], canvas.shape[1]
    return canvas.reshape(n, t, 4, t).transpose(0, 1, 3, 2)

"""The B operand of the 1-bit tensor-core tile product
(``csrc/bmma_tile.cuh``), shared by the two sweeps that count with it.

Both sweeps read masks as the product's B operand, 8 masks to a tile: 4
nodes (``cart_sweep``) or 4 fits (``scm_sweep``) x one pair of masks each
(two classes of a node; the negative and positive examples of a fit).
:func:`pack_mask_tiles` lays (N, C, W) masks out in the order the fragments
want them, so that a kernel copies them to shared memory as they are.
"""

from __future__ import annotations

import torch

__all__ = ["TILE_LANES", "TILE_NODES", "TILE_WORDS", "pack_mask_tiles",
           "tile_plan"]

TILE_NODES = 4  # nodes (or fits) of one mask tile: 8 masks, a pair per node
TILE_WORDS = 4  # 32-bit words of depth per tensor-core step (128 bits)
TILE_LANES = 32


def tile_plan(n, c, w):
    """(groups, pairs, steps) of the mask tiles of n nodes x c classes x w
    words: nodes in groups of 4, classes in pairs, words in steps of 4."""
    return -(-n // TILE_NODES), -(-c // 2), -(-w // TILE_WORDS)


def pack_mask_tiles(class_masks):
    """The (N, C, W) class masks in the kernels' fragment order: (groups,
    pairs, steps, 32) int32 with word ``[g, q, s, 4 * (2 * j + e) + t]`` =
    word ``4 * s + t`` of the mask of node ``4 * g + j``, class ``2 * q +
    e``, and 0 where that node, class or word does not exist."""
    n, c, w = class_masks.shape
    groups, pairs, steps = tile_plan(n, c, w)
    padded = torch.nn.functional.pad(
        class_masks, (0, steps * TILE_WORDS - w, 0, 2 * pairs - c,
                      0, groups * TILE_NODES - n))
    return (padded.view(groups, TILE_NODES, pairs, 2, steps, TILE_WORDS)
            .permute(0, 2, 4, 1, 3, 5)
            .reshape(groups, pairs, steps, TILE_LANES).contiguous())

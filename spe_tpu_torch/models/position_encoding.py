"""Positional encodings (port of spe_tpu/models/position_encoding.py;
reference models/position_encoding.py).

The sine variant is the function ops/embeds.py `position_embedding_sine`;
this module adds the learned one (reference PositionEmbeddingLearned
:60-85) and `build_position_encoding`, the `--position_embedding`
dispatch: 'sine'/'v2' or 'learned'/'v3', anything else raises (reference
:88-97).
"""

from __future__ import annotations

import torch
import torch.nn as nn

GRID = 50   # rows of each learned table (reference :66-67)


class PositionEmbeddingLearned(nn.Module):
    """Learned 50-row column and row tables; the embedding of grid cell (y,
    x) is [col_embed[x] ++ row_embed[y]]. It ignores the pad mask, as the
    reference does. State-dict names are DETR's (`col_embed.weight`,
    `row_embed.weight`, nn.Embedding(50, num_pos_feats))."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.row_embed = nn.Embedding(GRID, num_pos_feats)
        self.col_embed = nn.Embedding(GRID, num_pos_feats)

    def forward(self, B: int, H: int, W: int):
        """-> (B, H, W, 2 * num_pos_feats) f32."""
        if H > GRID or W > GRID:
            raise ValueError(f"a {H} x {W} grid is larger than the learned "
                             f"position tables' {GRID} x {GRID}")
        F = self.num_pos_feats
        x_emb = self.col_embed.weight[:W]
        y_emb = self.row_embed.weight[:H]
        pos = torch.cat([x_emb[None].expand(H, W, F),
                         y_emb[:, None].expand(H, W, F)], dim=-1)
        return pos[None].expand(B, H, W, 2 * F)


def build_position_encoding(hidden_dim: int, kind: str = "sine"):
    """-> the learned module, or None for the sine embedding (the function
    position_embedding_sine, which reads the grid's pad mask)."""
    if kind in ("v2", "sine"):
        return None
    if kind in ("v3", "learned"):
        return PositionEmbeddingLearned(hidden_dim // 2)
    raise ValueError(f"not supported {kind}")


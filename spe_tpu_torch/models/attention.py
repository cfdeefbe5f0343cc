"""The attention flavours' parameters (port of spe_tpu/models/attention.py).

Each class holds one flavour's weights under the reference state-dict names.
Its arithmetic is not here: every flavour runs inside one of the four fused
layers, whose plain PyTorch version (`*_reference` in
spe_tpu_torch/ops/fused_*.py) is the one plain version of that layer. With
the fused flags off a model calls that plain version, handing it the
attention to use: its plain math, or with `use_pallas_attention` the
standalone kernels (ops/talking_heads.py, ops/fused_mha.py); with them on
it calls the fused layer (the kernels for CUDA tensors).

  TalkingHeadsAttention  CaiT patch blocks (reference cait.py:344-393);
                         math in layer_scale_block_reference
  MultiClassAttention    class attention returning the CAM source
                         (reference cait.py:91-139); class_attn_block_reference
  MultiheadAttention     encoder self-attention with packed in-projection
                         (torch nn.MultiheadAttention's parameter names);
                         encoder_layer_reference
  ProjectionFreeAttention  decoder attention on pre-projected q/k/v
                         (reference models/attention.py:55-175);
                         decoder_layer_reference
"""

from __future__ import annotations

import torch
import torch.nn as nn

from spe_tpu_torch.models.layers import Linear


class TalkingHeadsAttention(nn.Module):
    """qkv, the (H, H) pre- and post-softmax head mixes proj_l/proj_w (torch
    Linear layout, out x in), and proj."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim)
        self.proj_l = Linear(num_heads, num_heads)
        self.proj_w = Linear(num_heads, num_heads)
        self.proj = Linear(dim, dim)


class MultiClassAttention(nn.Module):
    """q from the class tokens only; k and v from the whole sequence."""

    def __init__(self, dim: int):
        super().__init__()
        self.q = Linear(dim, dim)
        self.k = Linear(dim, dim)
        self.v = Linear(dim, dim)
        self.proj = Linear(dim, dim)


class MultiheadAttention(nn.Module):
    """The packed in-projection of torch's nn.MultiheadAttention
    (in_proj_weight (3D, D), in_proj_bias) and out_proj."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)


class ProjectionFreeAttention(nn.Module):
    """Attention on q/k/v projected by the decoder layer: only out_proj."""

    def __init__(self, dim: int):
        super().__init__()
        self.out_proj = Linear(dim, dim)

"""CaiT two-branch backbone with multi-class-token CAMs (port of
spe_tpu/models/cait.py; reference models/cait.py `TSCAM_cait_two_branch`
:674-831 and the single-branch `TSCAM_cait` :531-670).

Batch-first (B, N, D); images NHWC; CAMs (B, C, h, w). Parameter names are
the reference state-dict names (`blocks.{i}.attn.qkv.weight`, ...).

With `use_fused_block` each LayerScale block runs as one fused layer
(ops/fused_block.py) and with `use_fused_ca` each class-attention block
likewise (ops/fused_ca_block.py): the CUDA kernels for CUDA tensors, their
plain versions for CPU tensors, forward and backward. With the flags off
the blocks run the plain eval versions under autograd on any device; with
`use_pallas` as well, their attentions run through the standalone kernels,
as the JAX package's flax blocks call them (models/attention.py:85-111,
166-172): the patch blocks' through talking_heads (B5), the
class-attention blocks' through fused_mha (B4), each an autograd Function
that dispatches by device like the fused layers.

In training mode (`.train()`, with a torch.Generator passed to forward) the
JAX package's dropout sites apply: dropout after the position embedding at
`drop_rate` (cait.py:377); in every patch block attention dropout at
`attn_drop_rate`, projection and MLP dropout at `drop_rate`, and DropPath
at one uniform `drop_path_rate` (cait.py:150-154, 395-415). The
class-attention blocks have none. The plain blocks draw their masks with
torch.rand from the generator; the fused blocks draw one seed per call
from it and use counter masks (refmath.counter_keep).

With `remat` (`--remat`) every patch block and det-branch block runs under
torch.utils.checkpoint in training, as the JAX package wraps them in
nn.remat (cait.py:391-415): its activations are recomputed in the backward.
A block draws its randomness before the checkpointed region (the fused
layer's and the talking-heads kernel's seeds, a snapshot of the
generator's state for the plain masks, which each run of the block
replays), so the recompute sees the forward's masks and the generator
ends where one forward leaves it: remat on and off give the same bits.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from spe_tpu_torch.models.attention import (MultiClassAttention,
                                            TalkingHeadsAttention)
from spe_tpu_torch.models.layers import (LayerNorm, Linear, Mlp, PatchEmbed,
                                         dropout_for, interpolate_pos_embed)
from spe_tpu_torch.ops.fused_block import (fold_attention,
                                           fused_layer_scale_block,
                                           layer_scale_block_reference)
from spe_tpu_torch.ops.fused_ca_block import (class_attention,
                                              class_attn_block_reference,
                                              fused_class_attn_block)
from spe_tpu_torch.ops.fused_mha import layer_attention
from spe_tpu_torch.ops.refmath import CounterDropout, draw_seed, needs_grad
from spe_tpu_torch.ops.talking_heads import block_attention
from spe_tpu_torch.parallel.tp import NO_TP


class LayerScaleBlock(nn.Module):
    """x += gamma_1 * attn(norm1(x)); x += gamma_2 * mlp(norm2(x))
    (reference LayerScale_Block, cait.py:396-416)."""

    tp = NO_TP   # tensor parallelism (parallel/sharding_rules.shard_model)

    def __init__(self, dim, num_heads, mlp_ratio=4.0, init_scale=1e-4,
                 use_fused=False, drop=0.0, attn_drop=0.0, drop_path=0.0,
                 use_pallas=False, remat=False):
        super().__init__()
        self.num_heads = num_heads
        self.use_fused = use_fused
        self.remat = remat
        self.attention = block_attention if use_pallas else fold_attention
        self.rates = dict(attn=attn_drop, proj=drop, path=drop_path)
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = TalkingHeadsAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_scale)))
        self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_scale)))

    def forward(self, x, gen=None):
        """The block; its randomness is drawn first, then the block runs
        (under checkpoint with `remat` while autograd records): the fused
        layer's counter-mask seed, one per block call as JAX draws one per
        block (cait.py:176-180), and the talking-heads kernel's seed are
        drawn here and handed in; the plain masks (torch.rand) come from a
        generator at this call's snapshot of `gen`'s state, so a recompute
        draws them again, and `gen` takes the state the first run left."""
        drop = dropout_for(self, gen, **self.rates)
        seed = state = None
        if drop is not None:
            if self.use_fused or (self.attention is block_attention
                                  and drop.attn > 0.0):
                seed = draw_seed(gen, x.device)
            if not self.use_fused:
                state = gen.get_state()
        after = []

        def run(x):
            d = drop
            if state is not None:
                replay = torch.Generator(gen.device)
                replay.set_state(state)
                d = dataclasses.replace(drop, gen=replay)
            out = self.compute(x, d, seed)
            if state is not None and not after:
                after.append(replay.get_state())
            return out

        if self.remat and needs_grad([x, *self.parameters()]):
            out = checkpoint(run, x, use_reentrant=False)
        else:
            out = run(x)
        if after:
            gen.set_state(after[0])
        return out

    def compute(self, x, drop=None, seed=None):
        """The block on its drawn randomness: drop the plain block's
        refmath.Dropout (or None), seed the fused layer's or the
        talking-heads kernel's (1,) int32 seed (or None)."""
        params = dict(self.named_parameters())
        if self.use_fused:
            cd = None if seed is None else CounterDropout(
                seed, drop.attn, drop.proj, drop.path)
            return fused_layer_scale_block(x, params, self.num_heads, cd)
        attention = self.attention if seed is None else functools.partial(
            block_attention, seed=seed)
        return layer_scale_block_reference(x, params, self.num_heads, drop,
                                           attention, self.tp)


class LayerScaleBlockClassAttn(nn.Module):
    """Class-attention block over [cls ++ x] updating the class tokens only
    (reference LayerScale_Block_CA_MultiClass, cait.py:311-328).
    forward(x, cls) -> (new cls, attn (B, H, t, t+P))."""

    tp = NO_TP

    def __init__(self, dim, num_heads, mlp_ratio=4.0, init_scale=1e-4,
                 use_fused=False, use_pallas=False):
        super().__init__()
        self.num_heads = num_heads
        self.use_fused = use_fused
        self.attention = layer_attention if use_pallas else class_attention
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = MultiClassAttention(dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_scale)))
        self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_scale)))

    def forward(self, x, cls):
        params = dict(self.named_parameters())
        if self.use_fused:
            return fused_class_attn_block(cls, x, params, self.num_heads)
        return class_attn_block_reference(cls, x, params, self.num_heads,
                                          self.attention, self.tp)


def std_reweighting(cam):
    """Reweight per-head CAMs by their normalised std (ddof=1) and sum over
    heads (reference cait.py:801-806). cam: (B, H, C, P) -> (B, C, P) f32."""
    cam = cam.float()
    std = cam.std(dim=-1, keepdim=True, unbiased=True)
    std = std - std.amin(dim=1, keepdim=True)
    std = std / std.amax(dim=1, keepdim=True).clamp(min=1e-12)
    return (cam * std).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class CaiTConfig:
    img_size: int = 384
    patch_size: int = 16
    embed_dim: int = 192
    depth: int = 36
    num_heads: int = 4
    mlp_ratio: float = 4.0
    num_classes: int = 20
    layer_to_det: int = 24
    depth_token_only: int = 2
    init_scale: float = 1e-5
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    use_fused_block: bool = False
    use_fused_ca: "bool | None" = None  # None: follow use_fused_block
    two_branch: bool = True
    use_pallas: bool = False  # the standalone attention kernels (B4, B5)
    remat: bool = False   # checkpoint the patch and det-branch blocks


class CaiTTwoBranch(nn.Module):
    """forward(images (B, H, W, 3)) -> dict of
      x_logits (B, C), x_cls_logits (B, C), cams_cls (B, C, h, w) f32,
      x_patch (B, h, w, D) detection features."""

    def __init__(self, cfg: CaiTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        n_grid = cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.patch_size, D)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_grid * n_grid, D))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.extra_cls_token = nn.Parameter(torch.zeros(1, cfg.num_classes, D))

        def block():
            return LayerScaleBlock(D, cfg.num_heads, cfg.mlp_ratio,
                                   cfg.init_scale, cfg.use_fused_block,
                                   cfg.drop_rate, cfg.attn_drop_rate,
                                   cfg.drop_path_rate, cfg.use_pallas,
                                   cfg.remat)

        self.blocks = nn.ModuleList([block() for _ in range(cfg.depth)])
        if cfg.two_branch:
            self.blocks_det = nn.ModuleList(
                [block() for _ in range(cfg.depth - cfg.layer_to_det)])
            self.norm_det = LayerNorm(D, eps=1e-6)
        else:
            self.norm_to_det = LayerNorm(D, eps=1e-6)
        fused_ca = (cfg.use_fused_block if cfg.use_fused_ca is None
                    else cfg.use_fused_ca)
        self.blocks_token_only = nn.ModuleList([
            LayerScaleBlockClassAttn(D, cfg.num_heads, cfg.mlp_ratio,
                                     cfg.init_scale, fused_ca, cfg.use_pallas)
            for _ in range(cfg.depth_token_only)])
        self.norm = LayerNorm(D, eps=1e-6)
        self.cls_head = Linear(D, 1)
        self.cls_head_multi_cls = Linear(D, cfg.num_classes)

    def forward(self, images, gen=None):
        cfg = self.cfg
        B, H, W, _ = images.shape
        p = cfg.patch_size
        gh, gw = H // p, W // p
        n_grid = cfg.img_size // p
        x = self.patch_embed(images)
        pos = interpolate_pos_embed(self.pos_embed, (n_grid, n_grid), (gh, gw))
        x = x + pos.to(x.dtype)
        drop = dropout_for(self, gen, proj=cfg.drop_rate)
        if drop is not None:
            x = drop(x, drop.proj)
        D = cfg.embed_dim
        cls = torch.cat([self.cls_token.expand(B, 1, D),
                         self.extra_cls_token.expand(B, cfg.num_classes, D)],
                        dim=1).to(x.dtype)

        # two-branch: fork the det branch after block layer_to_det - 1
        # (cait.py:776-777); single-branch: capture at block index
        # layer_to_det (cait.py:627-629)
        x_feat = None
        for i, blk in enumerate(self.blocks):
            x = blk(x, gen)
            if cfg.two_branch and i + 1 == cfg.layer_to_det:
                x_feat = x
            if not cfg.two_branch and i == min(cfg.layer_to_det, cfg.depth - 1):
                x_feat = x
        if cfg.two_branch:
            for blk in self.blocks_det:
                x_feat = blk(x_feat, gen)
            x_feat = self.norm_det(x_feat)
        else:
            x_feat = self.norm_to_det(x_feat)

        first_attn = None
        for i, blk in enumerate(self.blocks_token_only):
            cls, attn = blk(x, cls)
            if i == 0:
                first_attn = attn
        tokens = self.norm(torch.cat([cls, x], dim=1))
        C = cfg.num_classes
        x_logits = self.cls_head(tokens[:, 1:1 + C])[..., 0]
        x_cls_logits = self.cls_head_multi_cls(tokens[:, 0])

        cam = first_attn[:, :, 1:1 + C, 1 + C:]
        cam = std_reweighting(cam) if cfg.two_branch else cam.float().mean(1)
        return {"x_logits": x_logits.float(),
                "x_cls_logits": x_cls_logits.float(),
                "cams_cls": cam.reshape(B, C, gh, gw),
                "x_patch": x_feat.reshape(B, gh, gw, D)}


def _cait(img_size, embed_dim, depth, num_heads, init_scale=1e-5, **kw):
    return CaiTConfig(img_size=img_size, embed_dim=embed_dim, depth=depth,
                      num_heads=num_heads, init_scale=init_scale, **kw)


# the JAX package's registry (spe_tpu/models/cait.py:474-511)
BACKBONE_REGISTRY = {
    "TSCAM_cait_XXS36_Two_Branch": lambda **kw: _cait(384, 192, 36, 4, **kw),
    "TSCAM_cait_XXS24_Two_Branch": lambda **kw: _cait(384, 192, 24, 4, **kw),
    "TSCAM_cait_XS24_Two_Branch": lambda **kw: _cait(384, 288, 24, 6, **kw),
    "TSCAM_cait_S24_Two_Branch": lambda **kw: _cait(384, 384, 24, 8, **kw),
    "TSCAM_cait_S36_Two_Branch": lambda **kw: _cait(384, 384, 36, 8, init_scale=1e-6, **kw),
    "TSCAM_cait_M36_Two_Branch": lambda **kw: _cait(384, 768, 36, 16, init_scale=1e-6, **kw),
    "TSCAM_cait_M48_Two_Branch": lambda **kw: _cait(448, 768, 48, 16, init_scale=1e-6, **kw),
    "TSCAM_cait_XXS24": lambda **kw: _cait(384, 192, 24, 4, two_branch=False, **kw),
    "TSCAM_cait_XXS36": lambda **kw: _cait(384, 192, 36, 4, two_branch=False, **kw),
    "TSCAM_cait_XXS24_224": lambda **kw: _cait(224, 192, 24, 4, two_branch=False, **kw),
    "TSCAM_cait_XXS36_224": lambda **kw: _cait(224, 192, 36, 4, two_branch=False, **kw),
    "TSCAM_cait_XXS24_224_Two_Branch": lambda **kw: _cait(224, 192, 24, 4, **kw),
    "TSCAM_cait_XS24": lambda **kw: _cait(384, 288, 24, 6, two_branch=False, **kw),
    "TSCAM_cait_S24_224": lambda **kw: _cait(224, 384, 24, 8, two_branch=False, **kw),
    "TSCAM_cait_S24": lambda **kw: _cait(384, 384, 24, 8, two_branch=False, **kw),
    "TSCAM_cait_S36": lambda **kw: _cait(384, 384, 36, 8, init_scale=1e-6,
                                         two_branch=False, **kw),
    "TSCAM_cait_M36": lambda **kw: _cait(384, 768, 36, 16, init_scale=1e-6,
                                         two_branch=False, **kw),
    "TSCAM_cait_M48": lambda **kw: _cait(448, 768, 48, 16, init_scale=1e-6,
                                         two_branch=False, **kw),
    "TSCAM_cait_tiny": lambda **kw: _cait(64, 32, 4, 2, **kw),
    "TSCAM_cait_mini": lambda **kw: _cait(128, 64, 6, 2, **kw),
}


def build_cait_config(name: str, num_classes: int, layer_to_det: int,
                      use_fused_block: bool = False, use_fused_ca=None,
                      drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                      drop_path_rate: float = 0.0,
                      use_pallas: bool = False,
                      remat: bool = False) -> CaiTConfig:
    if name not in BACKBONE_REGISTRY:
        raise KeyError(f"unknown backbone '{name}'; have {sorted(BACKBONE_REGISTRY)}")
    return BACKBONE_REGISTRY[name](
        num_classes=num_classes, layer_to_det=layer_to_det,
        use_fused_block=use_fused_block, use_fused_ca=use_fused_ca,
        drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
        drop_path_rate=drop_path_rate, use_pallas=use_pallas, remat=remat)

"""AdamW with the reference's three parameter groups, global-norm clipping,
StepLR and the non-finite skip (port of the update math of
spe_tpu/train/optim.py `flat_update` :128-166; reference main.py:177-191,
engine.py:163-165).

  groups  body at lr; the backbone body (`backbone.0.*`) at lr_backbone;
          its class-attention blocks (`blocks_token_only`) at lr_cls_head;
          with `--frozen_weights` every parameter outside the segmentation
          head in a frozen group at lr 0 (JAX optim.py:49-58, 195-201:
          optax.set_to_zero), which takes an exactly zero update, weight
          decay included
  clip    g <- g * (1 if |g| < clip else clip / |g|), |g| the global norm
          of every gradient, the frozen group's too (optax.chain(
          clip_by_global_norm, multi_transform))
  Adam    bias-corrected moments (b1 0.9, b2 0.999, eps 1e-8), then
          decoupled weight decay: d = m^ / (sqrt(v^) + eps) + wd * p
  StepLR  lr x 0.1 once the pre-increment update count reaches
          lr_drop epochs
  skip    a step whose loss or gradient norm is not finite leaves the
          parameters, both moments and the count untouched
Under tensor parallelism (parameters split by
parallel/sharding_rules.shard_model, marked `tp_shard`) the global norm
counts each replicated gradient once and sums the sharded ones' squares
over the model group, in one all-reduce that also carries whether any rank
saw a non-finite loss or replicated norm: every rank clips by the same
norm and takes the same skip.
The JAX package's flat-vector form is TPU plumbing; here the update runs
over the parameter lists with torch._foreach ops, one list per group.
"""

from __future__ import annotations

import torch

from spe_tpu_torch.config import SPEConfig
from spe_tpu_torch.models.segmentation import SEGM_PREFIXES

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def param_group(name: str, frozen: bool = False) -> str:
    """The reference's group of a parameter by its state-dict name; with
    `frozen` (--frozen_weights) "frozen" outside the segmentation head.
    The learned position tables (`backbone.1.*`) are in the body group, as
    the JAX package holds them outside its backbone."""
    if frozen and not name.startswith(SEGM_PREFIXES):
        return "frozen"
    if name.startswith("backbone.0."):
        return "cls_head" if ".blocks_token_only." in name else "backbone"
    return "body"


class AdamW3:
    """The optimizer over named parameters (a model's named_parameters());
    `step(loss)` applies one update from the parameters' .grad and returns
    (grad_norm as a 0-dim tensor, finite)."""

    def __init__(self, named_parameters, cfg: SPEConfig, steps_per_epoch: int):
        lrs = {"body": cfg.lr, "backbone": cfg.lr_backbone,
               "cls_head": cfg.lr_cls_head, "frozen": 0.0}
        self.groups, self.names = {}, {}
        for name, p in named_parameters:
            g = param_group(name, bool(cfg.frozen_weights))
            self.groups.setdefault(g, []).append(p)
            self.names.setdefault(g, []).append(name)
        self.lrs = {g: lrs[g] for g in self.groups}
        self.params = [p for ps in self.groups.values() for p in ps]
        self.exp_avg = {g: [torch.zeros_like(p) for p in ps]
                        for g, ps in self.groups.items()}
        self.exp_avg_sq = {g: [torch.zeros_like(p) for p in ps]
                           for g, ps in self.groups.items()}
        self.count = 0
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.lr_drop = cfg.lr_drop
        self.weight_decay = float(cfg.weight_decay)
        self.clip = float(cfg.clip_max_norm)
        self.tp = next((p.tp_shard for p in self.params
                        if getattr(p, "tp_shard", None) is not None), None)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @staticmethod
    def _grads(ps):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in ps]

    @torch.no_grad()
    def step(self, loss):
        grads = {g: self._grads(ps) for g, ps in self.groups.items()}
        norms = [n for gs in grads.values() for n in torch._foreach_norm(gs)]
        if self.tp is None:
            grad_norm = torch.linalg.vector_norm(torch.stack(norms))
            finite = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        else:
            grad_norm, finite = self._tp_norm(norms, loss)
        if not finite:
            return grad_norm, False
        scale = (torch.where(grad_norm < self.clip, 1.0, self.clip / grad_norm)
                 if self.clip > 0 else torch.ones((), device=grad_norm.device))
        c1 = self.count + 1
        bc1, bc2 = 1.0 - B1 ** c1, 1.0 - B2 ** c1
        factor = 0.1 if self.count // self.steps_per_epoch >= self.lr_drop \
            else 1.0
        for g, ps in self.groups.items():
            if g == "frozen":
                continue
            gs = torch._foreach_mul(grads[g], scale)
            m, v = self.exp_avg[g], self.exp_avg_sq[g]
            torch._foreach_mul_(m, B1)
            torch._foreach_add_(m, gs, alpha=1.0 - B1)
            torch._foreach_mul_(v, B2)
            torch._foreach_addcmul_(v, gs, gs, value=1.0 - B2)
            denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
            torch._foreach_add_(denom, ADAM_EPS)
            d = torch._foreach_div(torch._foreach_div(m, bc1), denom)
            torch._foreach_add_(d, ps, alpha=self.weight_decay)
            torch._foreach_add_(ps, d, alpha=-factor * self.lrs[g])
        self.count = c1
        return grad_norm, True

    def _tp_norm(self, norms, loss):
        """(the global norm, finite) over the model group (see above)."""
        sq = torch.stack(norms).float() ** 2
        sharded = torch.tensor([getattr(p, "tp_shard", None) is not None
                                for p in self.params], device=sq.device)
        rep = sq[~sharded].sum()
        buf = torch.stack([sq[sharded].sum(), (~(
            torch.isfinite(loss) & torch.isfinite(rep))).float()])
        self.tp.all_reduce_(buf)
        grad_norm = torch.sqrt(rep + buf[0])
        return grad_norm, bool(buf[1] == 0) and bool(torch.isfinite(grad_norm))

    def state_dict(self):
        return {"count": self.count, "exp_avg": self.exp_avg,
                "exp_avg_sq": self.exp_avg_sq}

    def load_state_dict(self, sd):
        self.count = int(sd["count"])
        for key in ("exp_avg", "exp_avg_sq"):
            for g, ts in getattr(self, key).items():
                for t, s in zip(ts, sd[key][g]):
                    t.copy_(s)

"""`--remat` in the port: the patch blocks and det-branch blocks under
torch.utils.checkpoint in training, their randomness drawn before the
checkpointed region (models/cait.LayerScaleBlock).

  (a) three steps of test_torch_train_step's tiny detector with remat on
      both sides and the port's fused backbone, against the JAX package's
      `remat=True` step (its nn.remat blocks): that file's tolerances,
      losses 1e-4 relative, parameters 5e-6 + 1e-4 relative;
  (b) the port alone at the voc0712 preset's dropout rates, with the fused
      flags off, with the fused backbone and with use_pallas_attention:
      two steps with remat and two without from one generator seed give
      the same losses, gradients, parameters and generator state, bit for
      bit (the recompute draws the forward's masks, and the generator
      advances once per block);
  (c) `--remat` from the command line reaches every patch and det-branch
      block: each runs twice in a training step (forward and recompute)
      and once in eval or under no_grad.
"""

import collections

import numpy as np
import pytest
import torch

from spe_tpu_torch import config as tconfig
from spe_tpu_torch.cli.main import parse_config
from spe_tpu_torch.models.build import build_model
from spe_tpu_torch.models.cait import LayerScaleBlock
from spe_tpu_torch.train.optim import AdamW3
from spe_tpu_torch.train.train_step import Gates, TrainState, train_step
from test_torch_train_step import CFG, _batches, _three_steps

# the voc0712 preset's dropout rates (config.voc0712_preset)
PRESET_DROPOUT = dict(dropout=0.1, backbone_drop_rate=0.07,
                      drop_path_rate=0.2, drop_attn_rate=0.05)


@pytest.fixture
def one_thread():
    """torch on one thread: the tiny steps' small ops otherwise spin its
    thread pool against the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_three_remat_steps_fused_backbone_match_jax(rng, one_thread):
    """(a): the JAX `remat=True` step (every patch and det-branch block in
    nn.remat) against the port's `remat=True` step with the fused backbone
    (on the CPU the block Function's plain training forward, run twice,
    and its hand-derived backward)."""
    _three_steps(rng, {"use_fused_block": True}, base={**CFG, "remat": True})


def _two_steps(flags, remat, batches):
    cfg = tconfig.SPEConfig(**{**CFG, **PRESET_DROPOUT, **flags,
                               "remat": remat})
    model = build_model(cfg, "cpu")
    state = TrainState(model, AdamW3(model.named_parameters(), cfg,
                                     steps_per_epoch=10))
    gen = torch.Generator().manual_seed(5)
    losses, grads = [], []
    for b in batches:
        m = train_step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                       cfg, Gates.for_epoch(cfg, 0), gen)
        losses.append({k: v.clone() for k, v in m.items()
                       if isinstance(v, torch.Tensor)})
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, grads, params, gen.get_state()


@pytest.mark.parametrize("flags", [
    {}, {"use_fused_block": True}, {"use_pallas_attention": True}],
    ids=["fused-off", "fused-backbone", "pallas-attention"])
def test_remat_equals_no_remat_with_dropout(rng, one_thread, flags):
    """(b): two steps with remat and two without, dropout at the preset's
    rates, one generator seed: bit for bit in the losses, every gradient,
    the parameters after the steps and the generator's final state."""
    batches = _batches(rng)[:2]
    off = _two_steps(flags, False, batches)
    on = _two_steps(flags, True, batches)
    for i, (lo, ln) in enumerate(zip(off[0], on[0])):
        assert lo.keys() == ln.keys()
        for k in lo:
            assert torch.equal(lo[k], ln[k]), (i, k, lo[k], ln[k])
    for i, (go, gn) in enumerate(zip(off[1], on[1])):
        assert go.keys() == gn.keys()
        assert any(n.startswith("backbone.0.body.blocks_det.") for n in go)
        for n in go:
            assert torch.equal(go[n], gn[n]), (i, n)
    for n, p in off[2].items():
        assert torch.equal(p, on[2][n]), n
    assert torch.equal(off[3], on[3])


TINY_ARGV = ["--backbone", "TSCAM_cait_tiny", "--layer_to_det", "2",
             "--enc_layers", "1", "--dec_layers", "1", "--nheads", "2",
             "--num_queries", "4", "--dim_feedforward", "16",
             "--num_classes", "5", "--max_size", "64", "--device", "cpu",
             "--compute_dtype", "float32", "--drop_path_rate", "0.2",
             "--backbone_drop_rate", "0.07", "--drop_attn_rate", "0.05"]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_remat_flag_checkpoints_every_patch_block(monkeypatch, one_thread,
                                                  fused):
    """(c): `--remat` builds a model whose patch and det-branch blocks run
    twice in a training step (the forward, then the recompute in the
    backward) and once without it, in eval and under no_grad; the
    class-attention blocks are not checkpointed."""
    calls = []
    compute = LayerScaleBlock.compute

    def counted(self, *args, **kw):
        calls.append(self)
        return compute(self, *args, **kw)

    monkeypatch.setattr(LayerScaleBlock, "compute", counted)
    flags = ["--use_fused_block" if fused else "--no_use_fused_block"]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    for remat in (True, False):
        cfg = parse_config(TINY_ARGV + flags + (["--remat"] if remat else []))
        assert cfg.remat == remat
        model = build_model(cfg).train()
        body = model.backbone[0].body
        blocks = [*body.blocks, *body.blocks_det]
        assert len(blocks) == 6
        assert all(b.remat == remat and b.use_fused == fused for b in blocks)
        calls.clear()
        out = model(x, generator=torch.Generator().manual_seed(0))
        assert calls == blocks
        (out["backbone"]["x_logits"].sum() +
         out["backbone"]["x_patch"].sum()).backward()
        # the recomputes run in the backward's order
        assert collections.Counter(map(id, calls)) == {
            id(b): 2 if remat else 1 for b in blocks}
        calls.clear()
        with torch.no_grad():
            model(x, generator=torch.Generator().manual_seed(0))
        model.eval()
        model(x)
        assert calls == blocks + blocks

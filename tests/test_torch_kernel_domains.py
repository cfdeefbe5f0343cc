"""`models/build.py`'s refusal of configurations outside the CUDA kernels'
shapes, on the CPU: `kernel_domain_errors` walks every registered backbone
under the voc0712 and coco17 presets' flags (every form, XXS24/XXS36,
XS24, S24, S36, M36 and M48, passes at 512^2; the test backbones' narrow
heads are refused), under the all-off flags (every backbone passes), and
against the training patches multi-scale buckets can give (up to 2048:
max_size 640 passes, 768 is refused), the single-branch XXS36 under both
presets with and without --remat; `build_model` on a CUDA device
raises by the backbone's name before it builds anything, and on the CPU
builds what the card refuses. Then the 16-head row passes' host side
(`kernels.th16_plan`): their grids, scratch rows and shared memory at
M48's, the multi-scale and ragged rows, and the row passes' domain at 16
heads."""

import pytest

from spe_tpu_torch.config import coco17_preset, voc0712_preset
from spe_tpu_torch.models.build import (build_model, kernel_domain_errors,
                                        training_patches)
from spe_tpu_torch.models.cait import BACKBONE_REGISTRY

OFF = dict(use_fused_block=False, use_fused_layers=False,
           use_pallas_attention=False)
# the forms the card's kernels take at the presets' widths and 512^2: every
# registered one
ACCEPTED = ("XXS24", "XXS36", "XS24", "S24", "S36", "M36", "M48")
TEST_BACKBONES = ("TSCAM_cait_tiny", "TSCAM_cait_mini")


def _form(name):
    return name.split("_")[2]


@pytest.mark.parametrize("name", sorted(BACKBONE_REGISTRY))
def test_preset_flags_against_kernel_domains(name):
    """Under the voc0712 and coco17 presets' flags every registered form
    fits every kernel (the test backbones' narrow heads are refused, each
    for a named kernel); with every flag off nothing is refused."""
    for cfg in (voc0712_preset(backbone=name), coco17_preset(backbone=name)):
        errors = kernel_domain_errors(cfg)
        assert kernel_domain_errors(cfg.replace(**OFF)) == []
        if name in TEST_BACKBONES:
            assert errors and all(("attention" in e or "ln_backward" in e or
                                   "talking heads" in e) for e in errors)
            continue
        assert _form(name) in ACCEPTED
        assert errors == [], (name, errors)


def test_coco17_preset_within_kernel_domains():
    """The coco17 preset (XXS36 at a fixed 512^2, 90 classes) lies inside
    every kernel's shapes: build_model takes it on the card."""
    assert kernel_domain_errors(coco17_preset()) == []


@pytest.mark.parametrize("preset", [voc0712_preset, coco17_preset])
def test_single_branch_xxs36_within_kernel_domains(preset):
    """The single-branch TSCAM_cait_XXS36 (the card's single-branch check
    runs it at the voc0712 preset with every fused flag on) lies inside
    every kernel's shapes under the presets' flags, with and without
    --remat: its 36 patch blocks and two class-attention blocks are the
    two-branch XXS36's, without the det-branch stack."""
    cfg = preset(backbone="TSCAM_cait_XXS36")
    assert not BACKBONE_REGISTRY["TSCAM_cait_XXS36"](
        num_classes=cfg.num_classes, layer_to_det=cfg.layer_to_det).two_branch
    assert cfg.use_fused_block and cfg.use_fused_layers
    assert training_patches(cfg, 16) == 1024
    assert kernel_domain_errors(cfg) == []
    assert kernel_domain_errors(cfg.replace(remat=True)) == []


@pytest.mark.parametrize("flag", ["use_fused_block", "use_fused_layers",
                                  "use_pallas_attention"])
def test_any_flag_routes_through_the_kernels(flag):
    """Any one fused flag or use_pallas_attention on is enough for the
    check to apply (here to 2304 training patches, past the row passes)."""
    cfg = voc0712_preset(backbone="TSCAM_cait_S24_Two_Branch", max_size=768,
                         fixed_size=False).replace(**OFF)
    assert kernel_domain_errors(cfg) == []
    assert kernel_domain_errors(cfg.replace(**{flag: True})) == [
        "2304 training patches (at most 2048)"]


def test_training_patches_against_row_passes():
    """The presets' fixed 512^2 gives 1024 patches; multi-scale buckets of
    128 at max_size 512 too, at 640 (the JAX bench's 512 x 640 buckets)
    1600, which the row passes take (two units of 4 columns a thread, up
    to 2048), at 768 2304, which is refused by name."""
    cfg = voc0712_preset()
    assert training_patches(cfg, 16) == 1024
    assert training_patches(cfg.replace(fixed_size=False), 16) == 1024
    wide = cfg.replace(fixed_size=False, max_size=640)
    assert training_patches(wide, 16) == 1600
    assert kernel_domain_errors(wide) == []
    wider = cfg.replace(fixed_size=False, max_size=768)
    assert training_patches(wider, 16) == 2304
    assert kernel_domain_errors(wider) == [
        "2304 training patches (at most 2048)"]
    assert kernel_domain_errors(wider.replace(**OFF)) == []


def test_build_model_refuses_on_the_card_only():
    """build_model raises on a CUDA device, naming the backbone and the
    kernel's limit, before any model is built (2304 training patches at
    max_size 768); on the CPU it builds the same configuration (here at a
    tiny size)."""
    cfg = voc0712_preset(backbone="TSCAM_cait_M48_Two_Branch", max_size=768,
                         fixed_size=False)
    with pytest.raises(NotImplementedError,
                       match="TSCAM_cait_M48_Two_Branch.*2304 training"):
        build_model(cfg, device="cuda")
    tiny = voc0712_preset(backbone="TSCAM_cait_tiny", max_size=64,
                          layer_to_det=2, enc_layers=1, dec_layers=1,
                          dim_feedforward=32, nheads=2, num_queries=4)
    assert kernel_domain_errors(tiny)
    with pytest.raises(NotImplementedError, match="TSCAM_cait_tiny"):
        build_model(tiny, device="cuda")
    assert build_model(tiny, device="cpu") is not None


# the 16-head row passes' host side (kernels.th16_plan, mirroring
# csrc/th_h16.cu's launchers): an H100's SMs, and a card whose wave is
# TH_BLOCKS blocks (the most the scratch holds)
H100_SMS = 132
TH16_FORMS = pytest.mark.parametrize(
    "backward,wl", [(True, False), (True, True), (False, False),
                    (False, True)], ids=["bwd", "bwd wl", "fwd", "fwd wl"])


@TH16_FORMS
@pytest.mark.parametrize("B,N", [(8, 1024), (2, 1600), (1, 2048), (2, 130),
                                 (1, 1281), (8, 2048)])
def test_th16_plan_covers_rows_once(backward, wl, B, N):
    """At M48's class, the N = 1600 bucket, 2048 keys and ragged rows, on
    an H100 and on a card of TH_BLOCKS blocks a wave: the blocks a SM each
    kernel is built for (two of the forward without wl, one of the others),
    which its shared memory allows; the blocks' runs of rows cover
    every (sample, query) row once, at most a wave of blocks, a row's
    chunks cover its keys within the 8 chunks the keep bits hold, two
    visits of each chunk a row, and the backward's sums of every block
    within th_bwd_scratch's rows (with wl too)."""
    from spe_tpu_torch.ops import kernels as K

    for n_sm in (H100_SMS, K.TH_BLOCKS):
        plan = K.th16_plan(B, N, n_sm, backward=backward, wl=wl)
        assert plan == K.th16_plan(B, N, n_sm, backward=backward, wl=wl)
        per_sm = 2 if not (backward or wl) else 1
        wave = min(per_sm * n_sm, K.TH_BLOCKS)
        assert plan["per_sm"] == per_sm and 1 <= plan["blocks"] <= wave
        per, rows = plan["rows_per_block"], B * N
        count = [0] * rows
        for k in range(plan["blocks"]):
            for r in range(k * per, min(rows, (k + 1) * per)):
                count[r] += 1
        assert count == [1] * rows
        assert (plan["chunks"] - 1) * K.TH16_CHUNK < N <= \
            plan["chunks"] * K.TH16_CHUNK
        assert plan["chunks"] <= K.TH_ROWS_MAX_N // K.TH16_CHUNK
        assert plan["visits"] == 2 * plan["chunks"] * per
        if backward:
            assert plan["width"] == (2 if wl else 1) * 256 + 32
            assert plan["width"] <= K.TH_BWD_MAX_WIDTH
            assert plan["blocks"] * plan["width"] <= \
                K.TH_BLOCKS * K.TH_BWD_MAX_WIDTH


@TH16_FORMS
def test_th16_plan_shared_memory(backward, wl):
    """Each 16-head kernel's shared memory (its rings of slots, the
    backward's keep bits and th_bwd_finish's arrays) stays under the
    H100's 227 KB a block, and the blocks it is built to share a SM with
    fit there too; the rings hold at least two slots a warp (one computed
    while the next is copied)."""
    from spe_tpu_torch.ops import kernels as K

    plan = K.th16_plan(8, 1024, H100_SMS, backward=backward, wl=wl)
    assert plan["smem"] <= K.SMEM_PER_BLOCK
    assert plan["per_sm"] * (plan["smem"] + 1024) <= K.SMEM_PER_SM
    assert plan["per_sm"] == K.TH16_BLOCKS_PER_SM[(backward, wl)]
    slot = (2 if backward else 1) * 16 * K.TH16_LD * 4
    assert plan["ring"] == (K.TH_NT // 32) * K.TH16_SLOTS[backward] * slot
    assert K.TH16_SLOTS[backward] >= 2
    # the padded head rows: 16-byte aligned, bank groups apart
    assert K.TH16_LD * 4 % 16 == 0 and K.TH16_LD % 32 == 4
    if backward:
        assert K.th_finish_smem(plan["width"]) == 4 * (K.TH_NT * 25 + 8 * 24)


@pytest.mark.parametrize("H,N,ok", [(16, 1, True), (16, 1024, True),
                                    (16, 1600, True), (16, 2048, True),
                                    (16, 2049, False), (12, 1024, False),
                                    (9, 64, False), (17, 64, False),
                                    (8, 2048, True), (4, 2049, False)])
def test_th_rows_domain_16_heads(H, N, ok):
    """The row passes' wrappers take 16 heads (th_h16.cu) up to 2048 keys,
    as the H <= 8 ones, and refuse 2049 keys and the head counts no kernel
    is built for, before any launch."""
    from spe_tpu_torch.ops import kernels as K

    if ok:
        K._th_rows_domain("th_bwd_rows", H, N)
        return
    with pytest.raises(ValueError, match="at most 2048 keys"):
        K._th_rows_domain("th_bwd_rows", H, N)

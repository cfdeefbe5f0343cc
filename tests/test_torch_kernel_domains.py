"""`models/build.py`'s refusal of configurations outside the CUDA kernels'
shapes, on the CPU: `kernel_domain_errors` walks every registered backbone
under the voc0712 preset's flags (the D = 192, 4-head XXS24/XXS36 forms
pass at 512^2; the XS24, S24, S36, M36 and M48 forms are refused), under
the all-off flags (every backbone passes), and against the training
patches multi-scale buckets can give; `build_model` on a CUDA device
raises by the backbone's name before it builds anything, and on the CPU
builds what the card refuses."""

import pytest

from spe_tpu_torch.config import voc0712_preset
from spe_tpu_torch.models.build import (build_model, kernel_domain_errors,
                                        training_patches)
from spe_tpu_torch.models.cait import BACKBONE_REGISTRY

OFF = dict(use_fused_block=False, use_fused_layers=False,
           use_pallas_attention=False)
# the forms the card's kernels take at the presets' widths and 512^2
ACCEPTED = ("XXS24", "XXS36")
REFUSED = ("XS24", "S24", "S36", "M36", "M48")
TEST_BACKBONES = ("TSCAM_cait_tiny", "TSCAM_cait_mini")


def _form(name):
    return name.split("_")[2]


@pytest.mark.parametrize("name", sorted(BACKBONE_REGISTRY))
def test_preset_flags_against_kernel_domains(name):
    """Under the preset's flags the XXS forms fit every kernel and the
    wider ones are refused, each for a named kernel; with every flag off
    nothing is refused."""
    cfg = voc0712_preset(backbone=name)
    errors = kernel_domain_errors(cfg)
    assert kernel_domain_errors(cfg.replace(**OFF)) == []
    if name in TEST_BACKBONES:
        return
    assert _form(name) in ACCEPTED + REFUSED
    if _form(name) in ACCEPTED:
        assert errors == [], (name, errors)
    else:
        assert errors and all(("attention" in e or "ln_backward" in e or
                               "talking heads" in e) for e in errors), name


@pytest.mark.parametrize("flag", ["use_fused_block", "use_fused_layers",
                                  "use_pallas_attention"])
def test_any_flag_routes_through_the_kernels(flag):
    """Any one fused flag or use_pallas_attention on is enough for the
    check to apply."""
    cfg = voc0712_preset(backbone="TSCAM_cait_S24_Two_Branch").replace(**OFF)
    assert kernel_domain_errors(cfg.replace(**{flag: True}))


def test_training_patches_against_row_passes():
    """The presets' fixed 512^2 gives 1024 patches (the row passes' limit);
    multi-scale buckets of 128 at max_size 512 too, at 640 (the JAX bench's
    512 x 640 buckets) 1600, which is refused."""
    cfg = voc0712_preset()
    assert training_patches(cfg, 16) == 1024
    assert training_patches(cfg.replace(fixed_size=False), 16) == 1024
    wide = cfg.replace(fixed_size=False, max_size=640)
    assert training_patches(wide, 16) == 1600
    assert any("training patches" in e for e in kernel_domain_errors(wide))
    assert kernel_domain_errors(wide.replace(**OFF)) == []


def test_build_model_refuses_on_the_card_only():
    """build_model raises on a CUDA device, naming the backbone, before
    any model is built; on the CPU it builds the same configuration (here
    at a tiny size)."""
    cfg = voc0712_preset(backbone="TSCAM_cait_M48_Two_Branch")
    with pytest.raises(NotImplementedError, match="TSCAM_cait_M48_Two_Branch"):
        build_model(cfg, device="cuda")
    tiny = voc0712_preset(backbone="TSCAM_cait_tiny", max_size=64,
                          layer_to_det=2, enc_layers=1, dec_layers=1,
                          dim_feedforward=32, nheads=2, num_queries=4)
    assert kernel_domain_errors(tiny)
    with pytest.raises(NotImplementedError, match="TSCAM_cait_tiny"):
        build_model(tiny, device="cuda")
    assert build_model(tiny, device="cpu") is not None

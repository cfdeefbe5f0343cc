"""Evaluation entry point of the port (the `--eval` path of spe_tpu/cli/main.py).

  python -m spe_tpu_torch.cli.main --preset voc0712 --eval \\
      --dataset_eval voc_voc --test_path <VOCdevkit> [--resume model.pth]

Flags are the JAX package's (`spe_tpu.config.config_from_args`). The model
runs on the CUDA card; `--device cpu` runs it on the CPU (the fused layers
then take their plain PyTorch versions). Without `--resume` the weights are
initialised from `--seed`; `--resume` takes a reference-layout .pth state
dict. Only the VOC eval path is ported: training raises.
"""

from __future__ import annotations

from spe_tpu.config import config_from_args
from spe_tpu_torch.data import eval_data
from spe_tpu_torch.models.build import build_model, resolve_device
from spe_tpu_torch.models.convert import load_reference_checkpoint
from spe_tpu_torch.train import engine


def parse_config(argv=None):
    """The JAX package's flags -> SPEConfig; refuses what is not ported."""
    cfg = config_from_args(argv)
    if not cfg.eval:
        raise NotImplementedError(
            "training is not ported yet: spe_tpu_torch runs the --eval path")
    if cfg.dataset_eval != "voc_voc":
        raise NotImplementedError(
            f"only --dataset_eval voc_voc is ported, got {cfg.dataset_eval}")
    return cfg


def main(argv=None):
    cfg = parse_config(argv)
    device = resolve_device(cfg)
    model = build_model(cfg, device)
    if cfg.resume:
        model.load_state_dict(load_reference_checkpoint(cfg.resume))
        print(f"loaded {cfg.resume}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"number of params: {n_params}")

    ds_val, loader = eval_data(cfg)
    stats = engine.evaluate_voc(model, loader, ds_val, cfg, device,
                                with_flip=cfg.eval)
    print(f"VOC mAP: {stats['mAP']:.4f}  CorLoc: {stats['CorLoc']:.4f}")
    return stats


if __name__ == "__main__":
    main()

"""Export a trained checkpoint's eval forward to a serving artifact, as the
JAX package's tools/export_model.py:

    python -m edge_enhancement_tpu_torch.tools.export_model --config <cfg.yml> \\
        --resume <ckpt dir or .pth> --out model.pt2 [--batch N] [--device cpu]

--resume takes the directory's best checkpoint, else its last. The
artifact (utils/export.py) is one torch.export file with the weights in
it, exported on the card (or on the CPU with --device cpu) and run on the
device it was exported on:

    from edge_enhancement_tpu_torch.utils.export import load_serving_artifact
    fn = load_serving_artifact("model.pt2")
    logits = fn(x, seed)          # x: [B,H,W,C] float32 in [0,1]

Loading needs torch and the port's K1 operator (load_serving_artifact
imports it); no model zoo, config system or checkpoint code.
"""

from __future__ import annotations

import os


def parser():
    from ..train.driver import parser as train_parser
    p = train_parser("export a serving artifact")
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--batch", type=int, default=None,
                   help="pin the batch dimension (default: symbolic)")
    return p


def main(argv=None) -> str:
    from ..data.datasets import SPECS
    from ..train.checkpoint import load_checkpoint, restore_into_state
    from ..train.driver import build, pin_precision, run_device
    from ..utils.config import load_config
    from ..utils.export import save_serving_artifact

    args = parser().parse_args(argv)
    cfg = load_config(args.config, vars(args))
    device = run_device(cfg)
    pin_precision(cfg)
    spec = SPECS[cfg["dataset"]]
    size = int(cfg.get("cize") or cfg.get("crop_size") or spec.image_size)
    ops, state, _ = build(cfg, spec.num_classes, device)
    if cfg.get("resume"):
        payload = (load_checkpoint(cfg["resume"], "best")
                   or load_checkpoint(cfg["resume"], "last"))
        if payload is None:
            raise FileNotFoundError(f"no checkpoint under {cfg['resume']}")
        state, epoch, _ = restore_into_state(state, payload)
        print(f"=> loaded checkpoint (epoch {epoch})")
    out = cfg["out"]
    save_serving_artifact(out, ops, size, spec.channels, batch=cfg.get("batch"))
    print(f"=> wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB, "
          f"batch={'symbolic' if cfg.get('batch') is None else cfg['batch']}, "
          f"device {device})")
    return out


if __name__ == "__main__":
    main()

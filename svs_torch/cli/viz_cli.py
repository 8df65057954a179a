"""``viz`` CLI: full-song prediction diagnostics (port of
``svs_tpu/cli/viz_cli.py``, reference aaa.py:10-191).

  --model_path --spec_path  (spec_path points at a MIXTURE _spec.npy; the
  GT vocal is found by replacing 'mixture' with 'vocal' in the path,
  aaa.py:36)

plus --device (default cuda): ``separate_magnitude`` runs there, the figure
is drawn on the host and needs matplotlib.

Run as ``python -m svs_torch.cli.viz_cli``.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Visual diagnostics of a "
                                            "full-song separation.")
    p.add_argument("--model_path", type=str, default="CKPT/svs_L1_SL_mid.pth")
    p.add_argument("--spec_path", type=str, required=True,
                   help="path to the MIXTURE spectrogram (_spec.npy)")
    p.add_argument("--out", type=str, default=None,
                   help="output png (default: viz_<name>_<model>.png)")
    p.add_argument("--preset", type=str, default="default")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the host)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    from svs_torch.cli.infer_cli import load_model
    from svs_torch.infer import separate
    from svs_torch.utils import viz
    from svs_torch.utils.config import get_config
    from svs_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.preset)
    if not os.path.exists(args.spec_path):
        print("Error: Mixture file not found.")
        return 1
    mix = np.load(args.spec_path)

    vocal_path = args.spec_path.replace("mixture", "vocal")  # aaa.py:36
    if os.path.exists(vocal_path):
        gt_vocal = np.load(vocal_path)
    else:
        print(f"Warning: GT Vocal file not found at {vocal_path}. "
              "Will use zeros.")
        gt_vocal = np.zeros_like(mix)

    try:
        model = load_model(args.model_path, cfg, device)
    except (OSError, RuntimeError, KeyError, ValueError) as e:
        print(f"Model load failed: {e}")
        return 1

    print("Running inference on full song...")
    pred = separate.separate_magnitude(model, mix, device=device)

    if args.out is None:
        name = os.path.basename(args.spec_path).replace(".npy", "")
        stem = os.path.splitext(os.path.basename(args.model_path))[0]
        args.out = f"viz_{name[:4]}_{stem}.png"
    out = viz.debug_figure(mix, gt_vocal, pred, args.out,
                           sample_rate=cfg.sample_rate,
                           hop_size=cfg.hop_size)
    print(f"Visualization saved to: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""``inference`` CLI — mask prediction over a folder of mixture spectrograms
(port of ``svs_tpu/cli/infer_cli.py``).

Flag surface preserved from reference inference.py:29-34:
  --model_path --tar --mixture_folder --vocal_solo
plus svs_tpu's --limit, --mode, --preset and --dtype, and --device (default
cuda).  svs_tpu's mesh decodes (--sp / --cp) wait for the port's parallel
slice.  Reference ``.pth`` checkpoints and the native ``.ckpt`` (written by
svs_torch's or svs_tpu's training) load through
``svs_torch.train.checkpoint.resume``, weights and BN statistics only.

Run as ``python -m svs_torch.cli.infer_cli``.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Separate vocal magnitude from mixture spectrograms.")
    p.add_argument("--model_path", type=str, required=True,
                   help="native .ckpt or reference-format .pth checkpoint")
    p.add_argument("--tar", type=str, required=True)
    p.add_argument("--mixture_folder", type=str, required=True)
    p.add_argument("--vocal_solo", type=int, default=1,
                   help="1: keep vocals; 0: remove vocals (1 - mask)")
    p.add_argument("--limit", type=int, default=None,
                   help="process only the first N files (the reference "
                        "hard-codes 20)")
    p.add_argument("--mode", type=str, default="segments",
                   choices=["segments", "whole", "overlap"],
                   help="'segments': reference parity (independent 128-frame "
                        "windows); 'whole': full-song single-patch forward; "
                        "'overlap': 50%%-overlap windows with triangular "
                        "crossfade (no segment seams)")
    p.add_argument("--preset", type=str, default="default")
    p.add_argument("--dtype", type=str, default=None,
                   choices=[None, "float32", "bfloat16"],
                   help="override the preset's conv compute dtype (the "
                        "shipped presets run bfloat16)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the host)")
    return p


def load_model(model_path: str, cfg, device):
    """The U-Net for ``cfg`` with a checkpoint's weights (a native ``.ckpt``
    or a reference ``.pth``), in eval mode on ``device``."""
    from svs_torch.train import checkpoint
    from svs_torch.train.step import create_train_state

    state = create_train_state(0, cfg, device="cpu")
    state, _, _ = checkpoint.resume(model_path, state, restore_opt=False)
    return state.model.to(device).eval()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import dataclasses

    import numpy as np

    from svs_torch.infer import separate
    from svs_torch.utils.config import get_config
    from svs_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.preset)
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    os.makedirs(args.tar, exist_ok=True)

    try:
        model = load_model(args.model_path, cfg, device)
    except (OSError, RuntimeError, KeyError, ValueError) as e:
        print(f"Failed to load model: {e}")
        return 1

    files = sorted(f for f in os.listdir(args.mixture_folder)
                   if f.endswith("_spec.npy"))
    if args.limit is not None:
        files = files[: args.limit]
    print(f"Found {len(files)} files, processing...")

    for i, name in enumerate(files):
        print(f"{i + 1}/{len(files)}: {name}")
        mix = np.load(os.path.join(args.mixture_folder, name))
        out = separate.separate_magnitude(
            model, mix, vocal_solo=bool(args.vocal_solo), mode=args.mode,
            device=device)
        np.save(os.path.join(args.tar, name), out)

    print("Separation finished!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

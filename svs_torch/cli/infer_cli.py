"""``inference`` CLI — mask prediction over a folder of mixture spectrograms
(port of ``svs_tpu/cli/infer_cli.py``).

Flag surface preserved from reference inference.py:29-34:
  --model_path --tar --mixture_folder --vocal_solo
plus svs_tpu's --limit, --mode, --preset, --dtype and --sp, and --device
(default cuda).  ``--sp`` decodes segment-parallel over the ranks of
``torchrun`` (``torchrun --nproc_per_node N -m svs_torch.cli.infer_cli --sp
...``), or alone at world size 1: every rank loads the model and masks its
share of each song's windows, and rank 0 writes the files
(``infer.separate.separate_magnitude_mesh``, modes ``segments`` and
``overlap``).  ``--cp`` (the halo-exchange decode, ROADMAP A.10.6) exits 2.
Reference ``.pth`` checkpoints and the native ``.ckpt`` (written by
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
    p.add_argument("--sp", action="store_true",
                   help="segment-parallel decode over the ranks of torchrun "
                        "(world size 1 without it); rank 0 writes")
    p.add_argument("--cp", action="store_true",
                   help="not ported (ROADMAP A.10.6)")
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
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cp:
        parser.error("--cp (the halo-exchange time-sharded decode) is not "
                     "ported to svs_torch yet (ROADMAP A.10.6)")
    if args.sp and args.mode == "whole":
        parser.error("--sp decodes --mode segments or overlap; 'whole' is "
                     "the halo-exchange decode (ROADMAP A.10.6)")
    import dataclasses

    import numpy as np

    from svs_torch.infer import separate
    from svs_torch.utils.config import get_config
    from svs_torch.utils.device import resolve_device

    mesh = None
    if args.sp:
        from svs_torch.parallel.mesh import make_mesh
        mesh = make_mesh(device=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    # rank 0 alone writes and prints
    primary = mesh is None or mesh.is_primary
    say = print if primary else (lambda *a, **k: None)
    cfg = get_config(args.preset)
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    if primary:
        os.makedirs(args.tar, exist_ok=True)

    try:
        model = load_model(args.model_path, cfg, device)
    except (OSError, RuntimeError, KeyError, ValueError) as e:
        say(f"Failed to load model: {e}")
        return 1

    files = sorted(f for f in os.listdir(args.mixture_folder)
                   if f.endswith("_spec.npy"))
    if args.limit is not None:
        files = files[: args.limit]
    say(f"Found {len(files)} files, processing...")

    for i, name in enumerate(files):
        say(f"{i + 1}/{len(files)}: {name}")
        mix = np.load(os.path.join(args.mixture_folder, name))
        if mesh is None:
            out = separate.separate_magnitude(
                model, mix, vocal_solo=bool(args.vocal_solo), mode=args.mode,
                device=device)
        else:
            out = separate.separate_magnitude_mesh(
                model, mix, mesh, vocal_solo=bool(args.vocal_solo),
                mode=args.mode)
        if primary:
            np.save(os.path.join(args.tar, name), out)

    say("Separation finished!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""``data`` CLI — wav <-> spectrogram conversion (port of
``svs_tpu/cli/data_cli.py``).

Flag surface preserved from reference data.py:20-28:
  --src --tar --phase --win_size --hop_size --sr --direction {to_spec,to_wave}
plus --device (default cuda; --device cpu runs on the host).

Run as ``python -m svs_torch.cli.data_cli``.
"""

from __future__ import annotations

import argparse

from svs_torch.utils.config import HOP_SIZE, SAMPLE_RATE, WINDOW_SIZE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert song folders to spectrograms and back.")
    p.add_argument("--src", type=str, required=True,
                   help="source folder (song folders for to_spec, "
                        "_spec.npy files for to_wave)")
    p.add_argument("--tar", type=str, required=True,
                   help="target folder")
    p.add_argument("--phase", type=str, default="-1",
                   help="phase folder (to_wave only)")
    p.add_argument("--win_size", type=int, default=WINDOW_SIZE)
    p.add_argument("--hop_size", type=int, default=HOP_SIZE)
    p.add_argument("--sr", type=int, default=SAMPLE_RATE)
    p.add_argument("--direction", default="to_spec",
                   choices=["to_spec", "to_wave"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device for the STFT/iSTFT (default cuda; "
                        "'cpu' runs on the host)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from svs_torch.data import prep

    if args.direction == "to_spec":
        n = prep.to_spec(args.src, args.tar, win_size=args.win_size,
                         hop_size=args.hop_size, sr=args.sr,
                         device=args.device)
        print(f"Processed {n} songs -> {args.tar}")
        if n == 0:
            print("Error: no song folders with mixture.wav found under "
                  f"{args.src}")
            return 1
    else:
        if args.phase == "-1":
            raise SystemExit("to_wave requires --phase (reference "
                             "data.py:118)")
        n = prep.to_wave(args.src, args.tar, args.phase,
                         win_size=args.win_size, hop_size=args.hop_size,
                         sr=args.sr, device=args.device)
        print(f"Reconstructed {n} files -> {args.tar}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

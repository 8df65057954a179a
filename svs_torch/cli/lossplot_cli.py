"""``lossplot`` CLI: the loss-curve figure from a LOG text file (port of
``svs_tpu/cli/lossplot_cli.py``, reference loss_plot.py with its
hard-coded filename an argument).  Needs matplotlib.

Run as ``python -m svs_torch.cli.lossplot_cli``.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Plot train/val loss curves from "
                                            "a LOG text file.")
    p.add_argument("log", nargs="?", default="LOG/log_L1_SL_mid.txt",
                   help="path to LOG/log_<label>.txt")
    p.add_argument("--out", type=str, default="output.png")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from svs_torch.utils.viz import plot_losses

    out = plot_losses(args.log, args.out)
    return 0 if out else 1


if __name__ == "__main__":
    raise SystemExit(main())

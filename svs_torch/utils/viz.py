"""Diagnostics: spectrogram visualizer and loss-curve plotter (port of
``svs_tpu/utils/viz.py``).

- :func:`debug_figure`: the 4-panel figure of reference aaa.py:116-182
  (GT vocal dB, predicted vocal dB, the dB difference clamped to +-40, the
  mean absolute error per frequency bin), with minute ticks from
  sample_rate / hop_size (aaa.py:168-169).
- :func:`parse_loss_log` / :func:`plot_losses`: reference loss_plot.py:
  11-112 (plain floats are train losses; ``Val <float>`` lines align to the
  previous train index), the input path an argument.

matplotlib is imported (with the Agg backend) only inside the two plotting
functions, so the module and :func:`parse_loss_log` work where matplotlib
is not installed; a plotting call there raises an ``ImportError`` that
names it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _amplitude_to_db(mag: np.ndarray, ref: float,
                     amin: float = 1e-5) -> np.ndarray:
    from svs_torch.ops.stft import amplitude_to_db

    return amplitude_to_db(torch.from_numpy(np.asarray(mag, np.float32)),
                           ref=ref, amin=amin).numpy()


def debug_figure(
    mix: np.ndarray,
    gt_vocal: np.ndarray,
    pred_vocal: np.ndarray,
    out_path: str,
    *,
    sample_rate: int = 8192,
    hop_size: int = 768,
) -> str:
    """Render the aaa.py 4-panel diagnostic figure; returns out_path."""
    plt = _pyplot()
    min_len = min(mix.shape[1], gt_vocal.shape[1], pred_vocal.shape[1])
    mix, gt, pred = (a[:, :min_len] for a in (mix, gt_vocal, pred_vocal))

    ref_value = float(np.max(mix)) + 1e-8  # aaa.py:104
    gt_db = _amplitude_to_db(gt, ref_value)
    pred_db = _amplitude_to_db(pred, ref_value)
    diff_db = pred_db - gt_db
    freq_err = np.mean(np.abs(diff_db), axis=1)

    fig = plt.figure(figsize=(15, 6))
    gs = fig.add_gridspec(2, 2)
    db_vmin, db_vmax = -80, 0

    ax2 = fig.add_subplot(gs[0, 0])
    ax2.set_title("2. True Vocal (Target)")
    im2 = ax2.imshow(gt_db, aspect="auto", origin="lower", cmap="magma",
                     vmin=db_vmin, vmax=db_vmax)
    plt.colorbar(im2, ax=ax2, format="%+2.0f dB")

    ax3 = fig.add_subplot(gs[0, 1])
    ax3.set_title("4. Predicted Vocal (Result)")
    im3 = ax3.imshow(pred_db, aspect="auto", origin="lower", cmap="magma",
                     vmin=db_vmin, vmax=db_vmax)
    plt.colorbar(im3, ax=ax3, format="%+2.0f dB")

    ax5 = fig.add_subplot(gs[1, 0])
    ax5.set_title("5. Difference in dB (Pred - True)")
    cmap = "berlin" if "berlin" in plt.colormaps() else "seismic"
    im5 = ax5.imshow(diff_db, aspect="auto", origin="lower", cmap=cmap,
                     vmin=-40, vmax=40)
    plt.colorbar(im5, ax=ax5, format="%+2.0f dB")

    ax6 = fig.add_subplot(gs[1, 1])
    ax6.set_title("6. Avg Absolute Error per Freq Bin (dB)")
    ax6.barh(np.arange(len(freq_err)), freq_err, color="salmon",
             edgecolor="none")
    ax6.text(10, 100, f"Avg: {freq_err.mean():.3f}", color="red",
             fontweight="bold")

    frames_per_min = 60 * sample_rate / hop_size
    ticks = np.arange(0, gt_db.shape[1], frames_per_min)
    labels = (ticks / frames_per_min).astype(int)
    for ax in (ax2, ax3, ax5):
        ax.set_xticks(ticks)
        ax.set_xticklabels(labels if ax is ax5 else [])
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)
    return out_path


def parse_loss_log(path: str) -> Tuple[List[float], List[float], List[int]]:
    """Parse the LOG text contract -> (train_losses, val_losses,
    val_x_indices), reference loss_plot.py:24-59 semantics."""
    train_losses: List[float] = []
    val_losses: List[float] = []
    val_x: List[int] = []
    current = 1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("Val"):
                try:
                    v = float(line.replace("Val", "").strip())
                except ValueError:
                    continue
                if current > 0:
                    val_losses.append(v)
                    val_x.append(current - 1)
            else:
                try:
                    train_losses.append(float(line))
                    current += 1
                except ValueError:
                    continue
    return train_losses, val_losses, val_x


def plot_losses(log_path: str, out_path: str = "output.png") -> Optional[str]:
    """Render the loss-curve figure (reference loss_plot.py:74-100)."""
    train, val, val_x = parse_loss_log(log_path)
    if not train:
        print("INFO: No valid Loss data found for plotting.")
        return None
    plt = _pyplot()
    plt.figure(figsize=(10, 6))
    plt.plot(range(len(train)), train, "-", color="blue", label="Train Loss",
             linewidth=1)
    if val:
        plt.plot(val_x, val, "--", color="red", label="Val Loss", marker="o",
                 markersize=3)
    plt.title("Training and Validation Loss Over Steps", fontsize=14)
    plt.xlabel("Training Step Index", fontsize=12)
    plt.ylabel("Loss Value", fontsize=12)
    plt.legend(loc="upper right")
    plt.grid(True, linestyle="--", alpha=0.6)
    if len(train) < 50:
        plt.xticks(range(len(train)))
    plt.savefig(out_path)
    plt.close()
    print(f"Total Train Loss points: {len(train)}")
    print(f"Total Val Loss points: {len(val)}")
    return out_path

"""Separation quality at validation time: vocal SDR / SIR / SAR / NSDR for
the training loop (port of ``svs_tpu/evaluation/val_sdr.py``).

The reference tracks only the combined loss while training (train.py:
313-363) and measures its headline metric, vocal SDR (evaluate.py:203-239),
in a separate offline pass over reconstructed wavs.  Here each validation
song is decoded from its on-disk spectrograms on the device
(``infer/separate.separate_magnitude``, then ``data/prep.istft_device``)
and scored with the 2-source BSS protocol of the ``evaluate`` CLI
(evaluate.py:26-84), on the device in float64 (``bss_torch``) or on the
host (``bss``).

Prep normalises each track's magnitude by the mixture's maximum
(data.py:84-85,105), one common factor per song; BSS-eval ratios do not
change under a common scale of references and estimates, so the SDR from
the normalised spectrograms equals the SDR on the original wavs up to the
phase reconstruction, as the offline ``to_wave -> evaluate`` chain
measures.  The best checkpoint stays chosen by the loss (reference
train.py:353-355); the SDR goes to the metrics JSONL and the printout.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch.nn as nn

from svs_torch.utils.config import SVSConfig
from svs_torch.utils.device import DeviceLike, resolve_device


def _load_pair(folder: str, name: str):
    spec = np.load(os.path.join(folder, name))
    phase = np.load(os.path.join(folder, name.replace("_spec.npy",
                                                      "_phase.npy")))
    min_len = min(spec.shape[1], phase.shape[1])
    return spec[:, :min_len].astype(np.float32), phase[:, :min_len]


def validation_sdr(
    model: nn.Module,
    valid_folder: str,
    cfg: Optional[SVSConfig] = None,
    *,
    mode: str = "segments",
    impl: str = "torch",
    max_songs: Optional[int] = None,
    device: DeviceLike = None,
) -> Dict[str, object]:
    """Decode every paired song under ``valid_folder/{mixture,vocal}`` with
    ``model`` on ``device`` (``cuda`` unless the caller asks for the CPU,
    where the model must lie) and return the mean vocal SDR / SIR / SAR /
    NSDR with the per-song values.

    ``mode``: the decode windowing of ``separate_magnitude`` ('segments'
    is the reference's).  ``impl``: 'torch' (BSS eval on ``device`` in
    float64) or 'numpy' (the host reference).  A song whose vocal is
    all-silent is skipped (BSS eval is undefined there, as in mir_eval), as
    is any song that fails to decode.  The model is scored in eval mode
    and left in the mode it came in."""
    from svs_torch.data import prep
    from svs_torch.infer.separate import separate_magnitude

    if impl == "torch":
        from svs_torch.evaluation import bss_torch

        def metrics(mix, ref, est):
            return bss_torch.compute_metrics_for_track(mix, ref, est,
                                                       device=dev)
    elif impl == "numpy":
        from svs_torch.evaluation import bss
        metrics = bss.compute_metrics_for_track
    else:
        raise ValueError(f"unknown impl {impl!r}; expected torch or numpy")

    cfg = cfg or SVSConfig()
    dev = resolve_device(device)
    mix_dir = os.path.join(valid_folder, "mixture")
    voc_dir = os.path.join(valid_folder, "vocal")
    names = sorted(f for f in os.listdir(mix_dir) if f.endswith("_spec.npy")
                   if os.path.exists(os.path.join(voc_dir, f)))
    if max_songs is not None:
        names = names[:max_songs]

    per_song: List[Dict[str, float]] = []
    skipped: List[str] = []
    was_training = model.training
    model.eval()
    try:
        for name in names:
            try:
                mix_mag, mix_phase = _load_pair(mix_dir, name)
                voc_mag, voc_phase = _load_pair(voc_dir, name)
                t = min(mix_mag.shape[1], voc_mag.shape[1])
                est_mag = separate_magnitude(model, mix_mag[:, :t],
                                             vocal_solo=True, mode=mode,
                                             device=dev)
                length = cfg.hop_size * (t - 1)  # to_wave's convention

                def wav(spec):
                    return prep.istft_device(
                        prep._pad_spec_frames(spec[:, :t]), cfg.window_size,
                        cfg.hop_size, length=length, device=dev)

                est = wav(est_mag * mix_phase[:, :t])
                ref = wav(voc_mag * voc_phase[:, :t])
                mix = wav(mix_mag * mix_phase[:, :t])
                m = metrics(mix, ref, est)
                per_song.append({"song": name[:-len("_spec.npy")], **m})
            except Exception as e:  # noqa: BLE001 (one song, not the run)
                skipped.append(f"{name}: {e}")
    finally:
        model.train(was_training)

    out: Dict[str, object] = {"per_song": per_song, "skipped": skipped}
    for k in ("SDR", "SIR", "SAR", "NSDR"):
        vals = [s[k] for s in per_song]
        out[k] = float(np.mean(vals)) if vals else None
    return out

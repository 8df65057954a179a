"""Experiment configuration (port of ``svs_tpu/utils/config.py``).

The reference keeps hyperparameters as module-level constants star-imported
everywhere (reference config.py:47-51) with historical presets left as
comments (config.py:11-44).  Here the same knobs are a frozen dataclass with
named presets, while module-level constants mirroring the reference's active
preset ("1209", config.py:46-51) are still exported for CLI default parity.

This is the port's own copy: every field and preset equals svs_tpu's
(tests/test_torch_config.py holds them together).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SVSConfig:
    """All knobs of the SVS pipeline.

    Mirrors reference config.py constants plus the implicit architecture /
    training constants scattered through reference model.py / train.py.
    """

    # --- DSP (reference config.py:47-49) ---
    window_size: int = 1024
    hop_size: int = 768
    sample_rate: int = 8192

    # --- patching (reference config.py:50-51) ---
    input_len: int = 128          # time frames per training patch
    samples_per_song: int = 64    # virtual-epoch patches per song

    # --- model (reference model.py:47-109) ---
    freq_bins: int = 512          # 513 rfft bins with DC dropped (train.py:110-113)
    enc_channels: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    kernel_size: int = 5
    stride: int = 2
    leaky_slope: float = 0.2      # model.py:50
    dropout_rate: float = 0.5     # model.py:83
    bn_eps: float = 1e-5          # torch BatchNorm2d default
    bn_momentum: float = 0.1      # torch BatchNorm2d default

    # --- training (reference train.py:24-25, model.py:116) ---
    learning_rate: float = 1e-3
    lr_drop_epoch: int = 400      # train.py:251
    lr_after_drop: float = 5e-4   # train.py:252
    alpha_l1: float = 166.66      # train.py:24
    alpha_mr: float = 0.66        # train.py:25

    # --- MR-STFT loss resolutions (auraloss MultiResolutionSTFTLoss defaults,
    #     constructed at reference train.py:26) ---
    mr_fft_sizes: Tuple[int, ...] = (1024, 2048, 512)
    mr_hop_sizes: Tuple[int, ...] = (120, 240, 50)
    mr_win_lengths: Tuple[int, ...] = (600, 1200, 240)
    # loss magnitude implementation (svs_torch/losses/mrstft.py):
    # 'matmul_bf16' (windowed-DFT matmuls with a bf16 output, the default;
    # on an sm_90 card the loss_partials kernels' rounded instances), 'fft'
    # (exact auraloss-parity path), or the hand-written CUDA kernels
    # 'pallas_bf16' (spectral_mag), 'pallas_fused' and 'pallas_fused_wide'
    # (loss_partials)
    mr_mag_impl: str = "matmul_bf16"

    # --- compute ---
    compute_dtype: str = "float32"   # "float32" | "bfloat16" for conv compute
    # space-to-depth lowering of the two edge convs in the JAX package; the
    # port accepts the flag (it changes no value) and runs the direct convs
    packed_edge_convs: bool = False
    # rematerialise encoder/decoder levels in the backward pass
    remat: bool = False

    @property
    def n_fft_bins(self) -> int:
        return self.window_size // 2 + 1  # 513


# Named presets mirroring the reference's comment-block presets
# (reference config.py:11-51).  Presets ship bfloat16 conv compute; bare
# ``SVSConfig()`` stays float32, the reference-exact numerical core.
PRESETS = {
    # "Low Res Train Params" (config.py:11-16)
    "low_res": SVSConfig(sample_rate=8192, hop_size=768, input_len=128,
                         samples_per_song=8, compute_dtype="bfloat16"),
    # "44100 Params" (config.py:18-23)
    "hq44k": SVSConfig(sample_rate=44100, hop_size=256, input_len=512,
                       samples_per_song=64, compute_dtype="bfloat16"),
    # "Fine Tune Params" (config.py:25-33)
    "fine_tune": SVSConfig(sample_rate=44100, hop_size=256, input_len=1536,
                           samples_per_song=16, learning_rate=5e-4,
                           compute_dtype="bfloat16", remat=True),
    # "1207 Params" (config.py:35-44)
    "p1207": SVSConfig(sample_rate=44100, hop_size=768, input_len=512,
                       samples_per_song=64, learning_rate=1e-4,
                       compute_dtype="bfloat16"),
    # "1209 Params" — the reference's ACTIVE preset (config.py:46-51)
    "default": SVSConfig(compute_dtype="bfloat16"),
    # no reference counterpart: the scaled-up flagship, 8x channel width
    # (~630M params vs the stock 9.6M)
    "wide": SVSConfig(enc_channels=(128, 256, 512, 1024, 2048, 4096),
                      compute_dtype="bfloat16"),
}


def get_config(preset: str = "default") -> SVSConfig:
    return PRESETS[preset]


# Module-level constants for reference CLI-default parity
# (star-imported in reference data.py:9 / train.py:10 / inference.py:7).
_cfg = PRESETS["default"]
WINDOW_SIZE = _cfg.window_size
HOP_SIZE = _cfg.hop_size
SAMPLE_RATE = _cfg.sample_rate
INPUT_LEN = _cfg.input_len
SAMPLES_PER_SONG = _cfg.samples_per_song


def num2str(n: int) -> str:
    """Zero-padded 4-digit index used in .npy file names (reference data.py:14-15)."""
    return str(n).zfill(4)

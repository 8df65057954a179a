"""Host-side WAV I/O (numpy RIFF parser) and resampling (port of
``svs_tpu/data/wav.py``).

The reference delegates audio I/O to librosa/soundfile (reference
data.py:78,166).  This is the port's own copy of svs_tpu's zero-dependency
RIFF parser (PCM 16/24/32, IEEE float32/64, WAVE_FORMAT_EXTENSIBLE) and its
scipy polyphase resampling (librosa.load's resample step, data.py:78,94).
The C++ loader branch of svs_tpu's ``load_audio`` waits for the port's
data-pipeline slice.
"""

from __future__ import annotations

import math
import struct
from typing import Optional, Tuple

import numpy as np

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_IEEE_FLOAT = 3
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file -> (float32 array (T,) mono or (C, T), sample_rate).

    Values are scaled to [-1, 1] like librosa/soundfile.
    """
    with open(path, "rb") as f:
        data = f.read()
    return parse_wav(data, name=path)


def parse_wav(data: bytes, name: str = "<bytes>") -> Tuple[np.ndarray, int]:
    """In-memory RIFF/WAVE parse (same contract as :func:`read_wav`); the
    serving path decodes request bodies directly, no temp-file round-trip."""
    path = name
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    raw = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    if len(fmt) < 16:
        raise ValueError(f"{path}: truncated fmt chunk ({len(fmt)} bytes)")

    audio_format, n_channels, sample_rate, _, _, bits = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        if len(fmt) < 26:
            raise ValueError(
                f"{path}: truncated extensible fmt chunk ({len(fmt)} bytes)")
        # subformat GUID's first 2 bytes carry the real format tag
        (audio_format,) = struct.unpack("<H", fmt[24:26])

    if audio_format == _WAVE_FORMAT_PCM:
        if bits == 16:
            y = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            y = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            i = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            i = np.where(i >= 1 << 23, i - (1 << 24), i)
            y = i.astype(np.float32) / 8388608.0
        elif bits == 8:
            y = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        y = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAVE format tag {audio_format}")

    if n_channels > 1:
        y = y[: (len(y) // n_channels) * n_channels]
        y = y.reshape(-1, n_channels).T
    return np.ascontiguousarray(y), sample_rate


def encode_wav(y: np.ndarray, sample_rate: int,
               subtype: str = "PCM_16") -> bytes:
    """Encode mono/(C,T) float audio to in-memory RIFF/WAVE bytes; subtype
    'PCM_16' (soundfile's default, matching reference data.py:166) or
    'FLOAT'."""
    y = np.atleast_2d(np.asarray(y, np.float32))  # (C, T)
    n_channels = y.shape[0]
    inter = y.T.reshape(-1)  # interleaved frames

    if subtype == "PCM_16":
        fmt_tag, bits = _WAVE_FORMAT_PCM, 16
        # round-to-nearest like libsndfile (astype would truncate toward 0,
        # a 1-LSB systematic bias vs the on-device quantiser)
        payload = np.round(
            np.clip(inter, -1.0, 1.0 - 1.0 / 32768) * 32768.0
        ).astype("<i2").tobytes()
    elif subtype == "FLOAT":
        fmt_tag, bits = _WAVE_FORMAT_IEEE_FLOAT, 32
        payload = inter.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    block_align = n_channels * bits // 8
    byte_rate = sample_rate * block_align
    return b"".join([
        b"RIFF", struct.pack("<I", 36 + len(payload)), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, fmt_tag, n_channels,
                             sample_rate, byte_rate, block_align, bits),
        b"data", struct.pack("<I", len(payload)), payload,
    ])


def write_wav(path: str, y: np.ndarray, sample_rate: int,
              subtype: str = "PCM_16") -> None:
    """Write mono/(C,T) float audio; see :func:`encode_wav`."""
    with open(path, "wb") as f:
        f.write(encode_wav(y, sample_rate, subtype))


def to_mono(y: np.ndarray) -> np.ndarray:
    """librosa.to_mono semantics: mean over channels (data.py:78 mono=True)."""
    return y if y.ndim == 1 else y.mean(axis=0).astype(np.float32)


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (librosa.load's sr= conversion, data.py:78).

    Uses scipy's polyphase filter; output length matches librosa's
    ceil(T * target/orig) convention.
    """
    if orig_sr == target_sr:
        return y.astype(np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    out = resample_poly(y, target_sr // g, orig_sr // g, axis=-1)
    n_out = int(math.ceil(y.shape[-1] * target_sr / orig_sr))
    if out.shape[-1] > n_out:
        out = out[..., :n_out]
    elif out.shape[-1] < n_out:
        pad = [(0, 0)] * (out.ndim - 1) + [(0, n_out - out.shape[-1])]
        out = np.pad(out, pad)
    return out.astype(np.float32)


def load_audio(path: str, sr: Optional[int] = None, mono: bool = True
               ) -> Tuple[np.ndarray, int]:
    """librosa.load equivalent (reference data.py:78, evaluate.py:22):
    read, optional mono mixdown, optional resample.  sr=None keeps native."""
    y, file_sr = read_wav(path)
    if mono:
        y = to_mono(y)
    if sr is not None and sr != file_sr:
        return resample(y, file_sr, sr), sr
    return y, file_sr

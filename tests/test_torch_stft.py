"""svs_torch.ops.stft against svs_tpu.ops.stft on the same numpy inputs.

Tolerances: both sides are float32 FFTs (torch's pocketfft against XLA's
CPU FFT) whose sums run in different orders, so values agree to a few f32
ulps of the spectrum's scale; atol 1e-4 on spectra of magnitude up to ~30
and on unit-scale waveforms leaves ~100x headroom over the observed gaps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svs_torch.ops import stft as tdsp
from svs_tpu.ops import stft as jdsp

ATOL = 1e-4


def _sig(rng, shape):
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


@pytest.mark.parametrize("shape,n_fft,hop,win,pad_mode", [
    ((8192,), 1024, 768, None, "constant"),      # reference prep geometry
    ((3, 5000), 1024, 256, None, "constant"),    # batched, K=4
    ((2, 4000), 512, 50, 240, "reflect"),        # MR-STFT: win < n_fft
    ((4001,), 2048, 240, 1200, "reflect"),
])
def test_stft_matches_jax(rng, shape, n_fft, hop, win, pad_mode):
    y = _sig(rng, shape)
    want = np.asarray(jdsp.stft(jnp.asarray(y), n_fft=n_fft, hop_length=hop,
                                win_length=win, pad_mode=pad_mode))
    got = tdsp.stft(torch.from_numpy(y), n_fft=n_fft, hop_length=hop,
                    win_length=win, pad_mode=pad_mode).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n_fft,hop,win,length", [
    (1024, 768, None, None),   # prep geometry, hop 768 against n_fft 1024
    (1024, 768, None, 6000),   # length= slices
    (1024, 256, None, 9000),   # length= pads past the covered span
    (512, 120, 300, None),     # win < n_fft
])
def test_istft_matches_jax(rng, n_fft, hop, win, length):
    n_bins, n_frames = n_fft // 2 + 1, 11
    S = (rng.standard_normal((2, n_bins, n_frames))
         + 1j * rng.standard_normal((2, n_bins, n_frames))).astype(
             np.complex64)
    want = np.asarray(jdsp.istft(jnp.asarray(S), hop_length=hop,
                                 win_length=win, n_fft=n_fft, length=length))
    got = tdsp.istft(torch.from_numpy(S), hop_length=hop, win_length=win,
                     n_fft=n_fft, length=length).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_istft_inverts_stft(rng):
    y = _sig(rng, (20_000,))
    S = tdsp.stft(torch.from_numpy(y), n_fft=1024, hop_length=768)
    back = tdsp.istft(S, hop_length=768, n_fft=1024, length=len(y)).numpy()
    covered = 768 * (S.shape[-1] - 1)  # past it, length= zero-pads
    np.testing.assert_allclose(back[:covered], y[:covered], atol=1e-5)
    assert (back[covered:] == 0).all()


def test_frame_and_overlap_add_match_jax(rng):
    y = _sig(rng, (2, 3001))
    want = np.asarray(jdsp.frame_signal(jnp.asarray(y), 300, 70))
    got = tdsp.frame_signal(torch.from_numpy(y), 300, 70).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jdsp.overlap_add(jnp.asarray(want), 70))
    got = tdsp.overlap_add(torch.from_numpy(got), 70).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_magphase_and_polar_match_jax(rng):
    S = (rng.standard_normal((9, 13)) + 1j * rng.standard_normal((9, 13))
         ).astype(np.complex64)
    S[0, :4] = 0  # zero bins: phase 1+0j
    jm, jp = map(np.asarray, jdsp.magphase(jnp.asarray(S)))
    tm, tp = tdsp.magphase(torch.from_numpy(S))
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-6)
    np.testing.assert_array_equal(tp.numpy()[0, :4], 1 + 0j)
    ang = rng.uniform(-np.pi, np.pi, (9, 13)).astype(np.float32)
    np.testing.assert_allclose(
        tdsp.polar(tm, torch.from_numpy(ang)).numpy(),
        np.asarray(jdsp.polar(jnp.asarray(jm), jnp.asarray(ang))), atol=1e-6)


def test_stft_magphase_and_istft_ri_match_jax(rng):
    y = _sig(rng, (30_000,))
    jm, jri = map(np.asarray, jdsp.stft_magphase_jit(jnp.asarray(y),
                                                     n_fft=1024,
                                                     hop_length=768))
    tm, tri = tdsp.stft_magphase(torch.from_numpy(y), 1024, 768)
    assert tri.shape == jri.shape == (2,) + jm.shape
    np.testing.assert_allclose(tm.numpy(), jm, atol=ATOL)
    # phase is ill-conditioned where |S| is small: compare mag * phase
    np.testing.assert_allclose(tm.numpy() * tri.numpy(), jm * jri, atol=ATOL)
    spec_ri = jm * jri
    want = np.asarray(jdsp.istft_ri_jit(jnp.asarray(spec_ri), n_fft=1024,
                                        hop_length=768))
    got = tdsp.istft_ri(torch.from_numpy(spec_ri), 1024, 768).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_hann_and_centered_dft_match_jax():
    # one f32 ulp of cos() between the two libraries' implementations
    np.testing.assert_allclose(tdsp.hann_window(1200).numpy(),
                               np.asarray(jdsp.hann_window(1200)), atol=1e-7)
    for a, b in zip(tdsp.centered_hann_dft(512, 240),
                    jdsp.centered_hann_dft(512, 240)):
        np.testing.assert_array_equal(a, b)

"""The stft_magphase and stft_magnitude front ends of the port against
svs_tpu's Pallas kernels.

On the CPU each wrapper takes the plain PyTorch version of the route its
n_fft selects (the fft route at these power-of-two sizes: the kernel's
packing, radix passes, split step and epilogue; the gemm basis is checked
below, the mixed route in tests/test_torch_mixed_frontend.py); it is held
against
``svs_tpu.ops.pallas.dsp.stft_magphase`` / ``stft_magnitude(...,
interpret=True)`` at K=2, K=3 and K=4, at n_fft 2048 and on the zero
signal.  Tolerance atol 2e-3 / rtol 1e-4, the bound
tests/test_pallas.py holds the Pallas kernel to against the exact FFT (both
sides are f32 windowed-DFT sums in different orders).

The CUDA kernel itself is held against this plain version on the card by
tests/test_torch_cuda.py and ``python3 chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svs_torch.ops.cuda import dsp as cdsp
from svs_tpu.ops.pallas import dsp as pdsp

ATOL, RTOL = 2e-3, 1e-4


def _pallas(y, n_fft, hop):
    mag, ri = pdsp.stft_magphase(jnp.asarray(y), n_fft, hop, interpret=True)
    return np.asarray(mag), np.asarray(ri)


@pytest.mark.parametrize("n,n_fft,hop", [
    (24_576, 1024, 768),   # K = 2, the default preset
    (12_000, 1024, 256),   # K = 4, the hq44k geometry
    (9_001, 512, 200),     # K = 3, a length that is no multiple of hop
    (20_000, 2048, 512),   # K = 4, n_fft 2048 (a radix-2 last pass)
])
def test_plain_matches_pallas(rng, n, n_fft, hop):
    y = (rng.standard_normal(n) * 0.3).astype(np.float32)
    want_mag, want_ri = _pallas(y, n_fft, hop)
    mag, ri = cdsp.stft_magphase(torch.from_numpy(y), n_fft, hop)
    mag, ri = mag.numpy(), ri.numpy()
    assert mag.shape == want_mag.shape and ri.shape == want_ri.shape
    np.testing.assert_allclose(mag, want_mag, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.hypot(ri[0], ri[1]), 1.0, atol=1e-5)
    # phase is ill-conditioned at small |S|: compare the complex spectrum
    np.testing.assert_allclose(mag * ri, want_mag * want_ri, atol=ATOL)


def test_zero_signal_phase_is_one():
    y = np.zeros(8192, np.float32)
    want_mag, want_ri = _pallas(y, 1024, 768)
    mag, ri = cdsp.stft_magphase(torch.from_numpy(y), 1024, 768)
    np.testing.assert_array_equal(mag.numpy(), want_mag)
    np.testing.assert_array_equal(ri.numpy(), want_ri)
    np.testing.assert_array_equal(ri.numpy()[0], 1.0)
    np.testing.assert_array_equal(ri.numpy()[1], 0.0)


def test_windowed_dft_matches_pallas_bases():
    """The port's bases are the Pallas kernel's, without its hop chunks, and
    the kernel's paired basis holds the same numbers."""
    k, hop, nbp = 2, 768, 640
    jc, js = pdsp._windowed_dft(1024, hop, k, nbp)
    jc, js = jc.reshape(k * hop, nbp), js.reshape(k * hop, nbp)
    tc, ts = cdsp.windowed_dft(1024)
    np.testing.assert_array_equal(tc, jc[:1024, :513])
    np.testing.assert_array_equal(ts, js[:1024, :513])
    paired = cdsp.paired_basis(1024)
    assert paired.shape == (1024, 1024)
    re, im = cdsp.unpair(torch.from_numpy(paired).T, 1024)
    np.testing.assert_array_equal(re.T.numpy(), jc[:1024, :513])
    # the sines of bin 0 and of the Nyquist bin are dropped: zero up to the
    # float64 rounding of sin(pi * t)
    np.testing.assert_array_equal(im.T.numpy()[:, 1:512], js[:1024, 1:512])
    assert np.abs(js[:1024, [0, 512]]).max() < 1e-12


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        cdsp.stft_magphase(torch.zeros(2, 100))
    with pytest.raises(TypeError):
        cdsp.stft_magphase(torch.zeros(4096, dtype=torch.float64))
    # an odd n_fft takes the mixed route up to 16384 and is refused above
    mag, ri = cdsp.stft_magphase(torch.zeros(4096), n_fft=1023)
    assert mag.shape == (512, 1 + 4095 // 768) and ri.shape == (2, *mag.shape)
    with pytest.raises(ValueError, match="odd n_fft=16385 above 16384"):
        cdsp.stft_magphase(torch.zeros(40_000), n_fft=16385)
    with pytest.raises(ValueError, match="at least 2"):
        cdsp.stft_magphase(torch.zeros(4096), n_fft=1)
    with pytest.raises(ValueError, match="hop"):
        cdsp.stft_magphase(torch.zeros(4096), n_fft=1024, hop_length=0)


def test_cpu_tensor_never_launches():
    before = cdsp.launches
    cdsp.stft_magphase(torch.zeros(4096))
    assert cdsp.launches == before


SHAPES = [
    (24_576, 1024, 768),   # K = 2, the default preset
    (12_000, 1024, 256),   # K = 4, the hq44k geometry
    (9_001, 512, 200),     # K = 3, a length that is no multiple of hop
    (20_000, 2048, 512),   # K = 4, n_fft 2048
]


@pytest.mark.parametrize("n,n_fft,hop", SHAPES)
def test_magnitude_plain_matches_pallas(rng, n, n_fft, hop):
    y = (rng.standard_normal(n) * 0.3).astype(np.float32)
    want = np.asarray(pdsp.stft_magnitude(jnp.asarray(y), n_fft, hop,
                                          interpret=True))
    got = cdsp.stft_magnitude(torch.from_numpy(y), n_fft, hop).numpy()
    assert got.shape == want.shape == (n_fft // 2 + 1, 1 + n // hop)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_magnitude_zero_signal_is_exactly_zero():
    y = np.zeros(8192, np.float32)
    want = np.asarray(pdsp.stft_magnitude(jnp.asarray(y), 1024, 768,
                                          interpret=True))
    got = cdsp.stft_magnitude(torch.from_numpy(y), 1024, 768).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, 0.0)


def test_magnitude_rejects_a_2d_signal():
    with pytest.raises(ValueError, match="1-D"):
        pdsp.stft_magnitude(jnp.zeros((2, 100)), interpret=True)
    with pytest.raises(ValueError, match="1-D"):
        cdsp.stft_magnitude(torch.zeros(2, 100))


def test_magnitude_cpu_tensor_never_launches():
    before = (cdsp.launches, cdsp.mag_launches)
    cdsp.stft_magnitude(torch.zeros(4096))
    assert (cdsp.launches, cdsp.mag_launches) == before

"""The stft_magphase front end of the port against svs_tpu's Pallas kernel.

On the CPU the wrapper takes its plain PyTorch version (same framing, bases
and epilogue as the CUDA kernel); it is held against
``svs_tpu.ops.pallas.dsp.stft_magphase(..., interpret=True)`` at K=2 and
K=4 and on the zero signal.  Tolerance atol 2e-3 / rtol 1e-4, the bound
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
    with pytest.raises(ValueError, match="even"):
        cdsp.stft_magphase(torch.zeros(4096), n_fft=1023)


def test_cpu_tensor_never_launches():
    before = cdsp.launches
    cdsp.stft_magphase(torch.zeros(4096))
    assert cdsp.launches == before

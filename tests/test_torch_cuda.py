"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (a CUDA kernel has no
CPU mode).  They import neither JAX nor svs_tpu, so they run on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance atol 2e-3 / rtol 1e-4: tests/test_pallas.py's bound for the TPU
kernel against the exact FFT; kernel and plain version are both true f32
sums (TF32 off) in different orders.
"""

import numpy as np
import pytest
import torch

from svs_torch.ops.cuda import dsp as cdsp

ATOL, RTOL = 2e-3, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version: true f32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = allow


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_fft,hop", [
    (2_097_152, 1024, 768),   # 4-minute song at 8192 Hz, bucket-padded
    (200_000, 1024, 256),     # K = 4
    (9_001, 512, 200),        # ragged frame and bin tiles
])
def test_stft_magphase_kernel_matches_plain(card, n, n_fft, hop):
    rng = np.random.default_rng(0)
    y = torch.from_numpy((rng.standard_normal(n) * 0.3).astype(
        np.float32)).to(card)
    before = cdsp.launches
    mag, ri = cdsp.stft_magphase(y, n_fft, hop)
    torch.cuda.synchronize()
    assert cdsp.launches == before + 1
    want_mag, want_ri = cdsp.stft_magphase_plain(y, n_fft, hop)
    assert mag.shape == want_mag.shape and ri.shape == want_ri.shape
    torch.testing.assert_close(mag, want_mag, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(mag * ri, want_mag * want_ri, atol=ATOL,
                               rtol=0)


@pytest.mark.cuda
def test_stft_magphase_kernel_zero_signal(card):
    mag, ri = cdsp.stft_magphase(torch.zeros(8192, device=card), 1024, 768)
    torch.cuda.synchronize()
    assert bool((mag == 0).all())
    assert bool((ri[0] == 1).all()) and bool((ri[1] == 0).all())

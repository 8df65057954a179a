"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (a CUDA kernel has no
CPU mode).  They import neither JAX nor svs_tpu, so they run on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances:
- stft_magphase, atol 2e-3 / rtol 1e-4: tests/test_pallas.py's bound for
  the TPU kernel against the exact FFT; kernel and plain version are both
  true f32 sums (TF32 off) in different orders.
- spectral_mag and loss_partials: both sides multiply the same bf16
  operands exactly and sum in f32 in different orders (the tensor cores'
  accumulators against cuBLAS's f32 GEMM), so magnitudes agree to atol
  2e-3 / rtol 1e-3 and partial sums to rtol 1e-4; the backward rounds the
  scaled re/im cotangents to bf16 on both sides, where one f32 ulp of
  difference moves a value by a bf16 ulp, so gradients are held to
  max|d|/max|g| < 2e-2 and cosine > 0.9999 (tests/test_fused_loss.py's
  bounds between two bf16 paths).
"""

import numpy as np
import pytest
import torch

from svs_torch.ops.cuda import diff_mag as cdm
from svs_torch.ops.cuda import dsp as cdsp
from svs_torch.ops.cuda import fused_loss as cfl

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


RESOLUTIONS = [(1024, 120, 600), (2048, 240, 1200), (512, 50, 240)]


def _waves(card, n, shape=(3, 9_001)):
    rng = np.random.default_rng(n)
    return [torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(
        np.float32)).to(card) for _ in range(2)]


def _close_grads(got, want):
    got, want = got.double(), want.double()
    assert ((got - want).abs().max() / want.abs().max()).item() < 2e-2
    cos = (got * want).sum() / (got.norm() * want.norm())
    assert cos.item() > 0.9999


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win", RESOLUTIONS)
def test_spectral_mag_kernels_match_plain(card, n_fft, hop, win):
    x, _ = _waves(card, 1)
    before = (cdm.fwd_launches, cdm.bwd_launches)
    mag = cdm.spectral_mag_fwd(x, n_fft, hop, win)
    torch.cuda.synchronize()
    want = cdm.spectral_mag_plain(x, n_fft, hop, win)
    assert mag.shape == want.shape
    torch.testing.assert_close(mag, want, atol=2e-3, rtol=1e-3)
    g = torch.randn(mag.shape, generator=torch.Generator(card).manual_seed(2),
                    device=card)
    dx = cdm.spectral_mag_bwd(x, g, n_fft, hop, win)
    torch.cuda.synchronize()
    assert (cdm.fwd_launches, cdm.bwd_launches) == (before[0] + 1,
                                                   before[1] + 1)
    _close_grads(dx, cdm.spectral_mag_bwd_plain(x, g, n_fft, hop, win))
    # no atomics: the backward gives the same bits on every run
    assert torch.equal(dx, cdm.spectral_mag_bwd(x, g, n_fft, hop, win))


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win", RESOLUTIONS)
def test_loss_partials_kernels_match_plain(card, n_fft, hop, win):
    x, y = _waves(card, 3)
    before = (cfl.fwd_launches, cfl.bwd_launches)
    p = cfl.loss_partials_fwd(x, y, n_fft, hop, win)
    torch.cuda.synchronize()
    torch.testing.assert_close(p, cfl.loss_partials_plain(x, y, n_fft, hop,
                                                          win),
                               atol=0, rtol=1e-4)
    g = torch.tensor([[0.7, 0.0, 1.3], [1.0, 2.0, -0.5], [0.0, 0.0, 1.0]],
                     device=card)
    dx = cfl.loss_partials_bwd(x, y, g, n_fft, hop, win)
    torch.cuda.synchronize()
    assert (cfl.fwd_launches, cfl.bwd_launches) == (before[0] + 1,
                                                   before[1] + 1)
    _close_grads(dx, cfl.loss_partials_bwd_plain(x, y, g, n_fft, hop, win))
    assert torch.equal(dx, cfl.loss_partials_bwd(x, y, g, n_fft, hop, win))


@pytest.mark.cuda
def test_loss_kernels_through_autograd(card):
    """The autograd Functions launch the kernels, and the target of the
    fused loss gets no gradient (one backward launch, not two)."""
    x, y = _waves(card, 4, shape=(2, 20_000))
    x.requires_grad_()
    y.requires_grad_()
    cfl.reset_counts()
    cfl.stft_loss_fused(x, y, 1024, 120, 600).backward()
    assert (cfl.fwd_launches, cfl.bwd_launches) == (1, 1)
    assert y.grad is None and torch.isfinite(x.grad).all()
    cdm.reset_counts()
    x.grad = None
    (cdm.spectral_mag(x, 512, 50, 240).log().sum()
     + cdm.spectral_mag(y.detach(), 512, 50, 240).sum()).backward()
    assert (cdm.fwd_launches, cdm.bwd_launches) == (2, 1)
    assert torch.isfinite(x.grad).all()


@pytest.mark.cuda
def test_perfect_prediction_has_a_finite_zero_safe_gradient(card):
    x, _ = _waves(card, 5, shape=(2, 12_000))
    x.requires_grad_()
    cfl.stft_loss_fused(x, x.detach(), 1024, 120, 600).backward()
    assert torch.isfinite(x.grad).all()

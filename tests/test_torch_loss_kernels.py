"""The port's MR-STFT loss kernels (plain PyTorch versions, CPU) against
svs_tpu's Pallas kernels in interpret mode.

``svs_torch.ops.cuda.diff_mag.spectral_mag`` and
``svs_torch.ops.cuda.fused_loss.loss_partials`` take their plain versions on
a CPU tensor: the same reflect pad, the same bf16 rounding of signal, basis
and re/im cotangents, float32 products.  They are held against
``svs_tpu.ops.pallas.diff_mag.spectral_mag`` and
``svs_tpu.ops.pallas.fused_loss.loss_partials`` (``_INTERPRET = True``, as
tests/test_fused_loss.py runs them) on the same numpy-seeded waveforms.

Tolerances.  tests/test_fused_loss.py and tests/test_diff_mag.py hold two
different bf16 paths to rtol 2e-4 (partials), 5e-3 (magnitudes) and
max|d|/max|g| < 2e-2 with cosine > 0.9999 (gradients).  The plain versions
round at exactly the Pallas kernels' points, so only the order of f32 sums
differs, and the bounds are tightened to ~10x what was observed:
- partial sums rtol 2e-6 (2.0e-7 observed);
- magnitudes atol 5e-5, rtol 1e-4 (8.6e-6 absolute observed, on
  magnitudes of order 1-10);
- gradients max|d|/max|g| < 1e-3 (4.5e-5 observed) and cosine > 0.99999:
  the scaled re/im cotangents are rounded to bf16 on both sides, where one
  f32 ulp of difference before the rounding moves a value by a bf16 ulp.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and ``python3 chip_smoke.py``.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp

from svs_torch.losses import mrstft as tmr
from svs_torch.ops import stft as tdsp
from svs_torch.ops.cuda import diff_mag as tdm
from svs_torch.ops.cuda import fused_loss as tfl
from svs_torch.ops.cuda import spectral as sp
from svs_tpu.ops.pallas import diff_mag as jdm
from svs_tpu.ops.pallas import fused_loss as jfl

RESOLUTIONS = [(1024, 120, 600), (2048, 240, 1200), (512, 50, 240)]


@pytest.fixture(autouse=True)
def one_thread():
    """One OpenMP thread (torch's intra-op pool) while a case runs,
    restored after it: Tier-1 runs six test files at once on eight cores,
    where a thread a core in each oversubscribes the CPU several times
    over.  Set through threadpoolctl: ``torch.set_num_threads`` also sets
    MKL's count, and once it has, MKL's float64 solve in ``bss_torch``
    hangs."""
    with threadpoolctl.threadpool_limits(1, user_api="openmp"):
        yield


@pytest.fixture(autouse=True)
def interpret_mode():
    jdm._INTERPRET = jfl._INTERPRET = True
    yield
    jdm._INTERPRET = jfl._INTERPRET = False


def _wave(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3
            ).astype(np.float32)


def _cos(a, b):
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def _close_grads(got, want):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-3
    assert _cos(got, want) > 0.99999


@pytest.mark.parametrize("n_fft,hop,win", RESOLUTIONS)
def test_spectral_mag_forward_and_grad_match_pallas(n_fft, hop, win):
    x = _wave(0, (2, 9000))
    w = np.random.default_rng(1).standard_normal(
        (2, n_fft // 2 + 1, 1 + 9000 // hop)).astype(np.float32)
    want = np.asarray(jdm.spectral_mag(jnp.asarray(x), n_fft, hop, win))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        jnp.log(jdm.spectral_mag(v, n_fft, hop, win)) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    before = (tdm.fwd_launches, tdm.bwd_launches)
    got = tdm.spectral_mag(xt, n_fft, hop, win)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-5,
                               rtol=1e-4)
    (torch.log(got) * torch.from_numpy(w)).sum().backward()
    _close_grads(xt.grad.numpy(), want_g)
    # the CPU path never counts as a kernel launch
    assert (tdm.fwd_launches, tdm.bwd_launches) == before


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n_fft,hop,win", RESOLUTIONS)
def test_loss_partials_forward_and_grad_match_pallas(n_fft, hop, win, wide):
    x, y = _wave(2, (2, 8000)), _wave(3, (2, 8000))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want = np.asarray(jfl.loss_partials(jx, jy, n_fft, hop, win, wide))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jfl.loss_partials(
        v, jy, n_fft, hop, win, wide)[:, (0, 2)]))(jx))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    got = tfl.loss_partials(xt, yt, n_fft, hop, win, wide)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-6)
    got[:, [0, 2]].sum().backward()
    _close_grads(xt.grad.numpy(), want_g)
    assert yt.grad is None  # the target gets no gradient


def test_loss_partials_bwd_uses_columns_0_and_2_only():
    x, y = torch.from_numpy(_wave(4, (1, 6000))), torch.from_numpy(
        _wave(5, (1, 6000)))
    g1 = tfl.loss_partials_bwd(x, y, torch.tensor([[1.0, 0.0, 1.0]]),
                               512, 50, 240)
    g2 = tfl.loss_partials_bwd(x, y, torch.tensor([[1.0, 7.0, 1.0]]),
                               512, 50, 240)
    torch.testing.assert_close(g1, g2, atol=0, rtol=0)


@pytest.mark.parametrize("impl", ["pallas_fused", "pallas_fused_wide"])
def test_weighted_drops_rows_exactly(impl):
    """weight [1, 0] equals the single-row batch: a zero-weight row drops
    out of all three partial sums (tests/test_fused_loss.py:71-84)."""
    x = torch.from_numpy(_wave(6, (2, 16000)))
    y = torch.from_numpy(_wave(7, (2, 16000)))
    a = tmr.stft_loss(x, y, 1024, 120, 600, impl=impl,
                      weight=torch.tensor([1.0, 0.0]))
    b = tmr.stft_loss(x[:1], y[:1], 1024, 120, 600, impl=impl)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_fused_weight_needs_2d_inputs():
    x = torch.zeros((2, 1, 8000))
    with pytest.raises(ValueError, match="weight needs"):
        tmr.stft_loss(x, x, 512, 50, 240, impl="pallas_fused",
                      weight=torch.ones(2))


def test_reflect_mirror_add_is_the_pad_adjoint():
    """The fold's mirror-add equals autograd through F.pad(reflect), on the
    whole gradient (an off-by-one shows only in the first and last
    n_fft/2 samples)."""
    geo = sp.Geometry(2, 300, 256, 50, 256)
    g = torch.from_numpy(_wave(8, (2, geo.t_padded)))
    x = torch.zeros((2, 300), requires_grad=True)
    (sp.reflect_pad(x, geo.pad) * g).sum().backward()
    torch.testing.assert_close(sp.mirror_add(g, geo), x.grad, atol=0, rtol=0)


def test_paired_columns_round_trip():
    paired = torch.from_numpy(sp.paired_basis(512, 240))
    re, im = sp.unpair(paired)
    c, s = tdsp.centered_hann_dft(512, 240)
    np.testing.assert_array_equal(re.numpy(), c)
    # the sines of bin 0 and Nyquist are zero: the pair drops them
    np.testing.assert_array_equal(im.numpy()[:, 1:-1], s[:, 1:-1])
    torch.testing.assert_close(sp.pair(re, im), paired, atol=0, rtol=0)


def test_geometry_matches_pallas_geometry():
    for n_fft, hop, win in RESOLUTIONS:
        for t in (9001, 97_536):
            geo = sp.Geometry(3, t, n_fft, hop, win)
            k, n_frames, _, _, n_bins, _ = jdm._geometry(t, n_fft, hop)
            assert (geo.k, geo.n_frames, geo.n_bins) == (k, n_frames, n_bins)
            # the kernels' one tap range (forward and backward) covers the
            # window, in whole 64-tap stages from a 16-byte aligned tap
            assert geo.tap_lo <= geo.left
            assert geo.tap_lo + geo.n_taps >= geo.left + win
            assert geo.n_taps % sp.STAGE == 0 and geo.tap_lo % 8 == 0
            # at most one stage deeper than the window needs
            assert geo.n_taps - sp.STAGE < geo.left + win - geo.tap_lo
            # the last frame's read stays inside the padded row
            assert ((geo.n_frames - 1) * hop + geo.tap_lo + geo.n_taps
                    <= geo.stride)


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 4000), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdm.spectral_mag_fwd(x, 512, 50, 240)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfl.loss_partials_fwd(x, x, 512, 50, 240)

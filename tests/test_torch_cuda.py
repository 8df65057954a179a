"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (a CUDA kernel has no
CPU mode).  They import neither JAX nor svs_tpu, so they run on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances:
- stft_magphase and stft_magnitude, atol 2e-3 / rtol 1e-4:
  tests/test_pallas.py's bound for the TPU kernel against the exact FFT;
  kernel and plain version are both true f32 sums (TF32 off) in different
  orders.  The fft or mixed route against the gemm route: 4e-6 of the
  largest magnitude, tests/test_torch_fft_frontend.py's and
  tests/test_torch_mixed_frontend.py's bound between their plain versions
  (each is within its f32 rounding of the exact DFT).
- spectral_mag and loss_partials: both sides multiply the same bf16
  operands exactly and sum in f32 in different orders (the tensor cores'
  accumulators against cuBLAS's f32 GEMM), so magnitudes agree to atol
  2e-3 / rtol 1e-3 and partial sums to rtol 1e-4 (the kernel's log is
  lg2.approx, whose error of ~2^-22 is far inside that); the backward
  rounds the scaled re/im cotangents to bf16 on both sides, where one f32
  ulp of difference moves a value by a bf16 ulp, so gradients are held to
  max|d|/max|g| < 2e-2 and cosine > 0.9999 (tests/test_fused_loss.py's
  bounds between two bf16 paths).  The rounded instances
  (``mr_mag_impl='matmul_bf16'``) are held to their rounded plain twin at
  the same bounds, and the loss through them to the PyTorch composition at
  tests/test_torch_losses.py's ``matmul_bf16`` bounds (1e-3 relative on
  values, the gradients' as above).
- the decode's captured programs (``svs_torch/infer/graphs.py``): a replay
  runs the eager body's kernels in its order, so it gives the eager body's
  bits (PCM16: 0 LSB), with cuDNN's deterministic algorithms for float32.
"""

import ctypes
import time

import numpy as np
import pytest
import torch

from svs_torch.ops.cuda import build
from svs_torch.ops.cuda import diff_mag as cdm
from svs_torch.ops.cuda import dsp as cdsp
from svs_torch.ops.cuda import fused_loss as cfl
from svs_torch.ops.cuda import spectral as sp

ATOL, RTOL = 2e-3, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    matmul = torch.backends.cuda.matmul
    allow = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_tf32 = False  # plain version: true f32
    # matmul_bf16's composition: bf16 products summed in f32, as specified
    # (cuBLAS may otherwise reduce split-K partial sums in bf16)
    matmul.allow_bf16_reduced_precision_reduction = False
    yield torch.device("cuda")
    matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = allow


_ROUTES = ("fft", "mixed", "gemm")


def _route_counts():
    return tuple(getattr(cdsp, f"{r}_launches") for r in _ROUTES)


def _moved(before, n_fft):
    """The route counters after one launch at ``n_fft``: its route's moved
    by one, the others' not at all."""
    via = cdsp.route(n_fft)
    return tuple(c + (r == via) for r, c in zip(_ROUTES, before))


# the mixed route at chip_smoke.py's shapes, cut to 300,000 samples
MIXED_SHAPES = [
    (300_000, 1536, 384),     # 768 = 8 * 8 * 4 * 3
    (300_000, 441, 110),      # odd, 7-smooth
    (300_000, 999, 256),      # odd, Bluestein (L = 2048)
    (300_000, 1018, 256),     # even, Bluestein (P = 509, L = 1024)
    (300_000, 8192, 2048),    # a power of two above the fft route's
    (100_001, 201, 100),      # odd, an odd frame count (1,001 frames)
]

FRONTEND_SHAPES = [
    (2_097_152, 1024, 768),   # 4-minute song at 8192 Hz, bucket-padded
    (200_000, 1024, 256),     # K = 4
    (9_001, 512, 200),        # ragged frame and bin tiles
    (300_000, 2048, 512),     # fft route, n_fft 2048
    (300_000, 4096, 1024),    # fft route, n_fft 4096
    (100_000, 1000, 250),     # mixed route: P = 500 = 4 * 5^3
    *MIXED_SHAPES,
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_fft,hop", FRONTEND_SHAPES)
def test_stft_magphase_kernel_matches_plain(card, n, n_fft, hop):
    rng = np.random.default_rng(0)
    y = torch.from_numpy((rng.standard_normal(n) * 0.3).astype(
        np.float32)).to(card)
    before, routes = cdsp.launches, _route_counts()
    mag, ri = cdsp.stft_magphase(y, n_fft, hop)
    torch.cuda.synchronize()
    assert cdsp.launches == before + 1
    assert _route_counts() == _moved(routes, n_fft)
    want_mag, want_ri = cdsp.plain_for(n_fft, True)(y, n_fft, hop)
    assert mag.shape == want_mag.shape and ri.shape == want_ri.shape
    torch.testing.assert_close(mag, want_mag, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(mag * ri, want_mag * want_ri, atol=ATOL,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(1024, 768), (1000, 250), (999, 256),
                                       (1018, 256)])
def test_stft_magphase_kernel_zero_signal(card, n_fft, hop):
    mag, ri = cdsp.stft_magphase(torch.zeros(8192, device=card), n_fft, hop)
    torch.cuda.synchronize()
    assert bool((mag == 0).all())
    assert bool((ri[0] == 1).all()) and bool((ri[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_fft,hop", [
    (1_966_080, 1024, 768),   # bench_cli --frontend's 240-s signal (K = 2)
    (200_000, 1024, 256),     # K = 4
    (9_001, 512, 200),        # ragged frame and bin tiles
    (300_000, 2048, 512),     # fft route, n_fft 2048
    (300_000, 4096, 1024),    # fft route, n_fft 4096
    (100_000, 1000, 250),     # mixed route
    *MIXED_SHAPES,
])
def test_stft_magnitude_kernel_matches_plain(card, n, n_fft, hop):
    rng = np.random.default_rng(1)
    y = torch.from_numpy((rng.standard_normal(n) * 0.3).astype(
        np.float32)).to(card)
    before, routes = (cdsp.launches, cdsp.mag_launches), _route_counts()
    mag = cdsp.stft_magnitude(y, n_fft, hop)
    torch.cuda.synchronize()
    assert (cdsp.launches, cdsp.mag_launches) == (before[0], before[1] + 1)
    assert _route_counts() == _moved(routes, n_fft)
    want = cdsp.plain_for(n_fft, False)(y, n_fft, hop)
    assert mag.shape == want.shape == (n_fft // 2 + 1,
                                       1 + (n - n_fft % 2) // hop)
    torch.testing.assert_close(mag, want, atol=ATOL, rtol=RTOL)
    # the magnitude of the magphase kernel is the same sum, the same bits
    assert torch.equal(mag, cdsp.stft_magphase(y, n_fft, hop)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(1024, 768), (1000, 250), (999, 256),
                                       (1018, 256)])
def test_stft_magnitude_kernel_zero_signal(card, n_fft, hop):
    mag = cdsp.stft_magnitude(torch.zeros(8192, device=card), n_fft, hop)
    torch.cuda.synchronize()
    assert mag.shape == (n_fft // 2 + 1, 1 + (8192 - n_fft % 2) // hop)
    assert bool((mag == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [True, False])
def test_fft_and_gemm_routes_agree(card, phase):
    """The gemm kernel also takes a power-of-two n_fft (which is how the
    redesign is timed against it): both routes give the same spectrum."""
    rng = np.random.default_rng(2)
    y = torch.from_numpy((rng.standard_normal(500_000) * 0.3).astype(
        np.float32)).to(card)
    fft = cdsp.launch(y, 1024, 768, phase, "fft")
    gemm = cdsp.launch(y, 1024, 768, phase, "gemm")
    torch.cuda.synchronize()
    mag, ref = (fft[0], gemm[0]) if phase else (fft, gemm)
    bound = 4e-6 * ref.abs().max().item()
    torch.testing.assert_close(mag, ref, atol=bound, rtol=0)
    if phase:
        torch.testing.assert_close(fft[0] * fft[1], gemm[0] * gemm[1],
                                   atol=bound, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", [True, False])
@pytest.mark.parametrize("n_fft,hop", [(1000, 250), (1018, 256)])
def test_mixed_and_gemm_routes_agree(card, phase, n_fft, hop):
    """The gemm kernel, the earlier design at these n_fft, gives the mixed
    kernel's spectrum (7-smooth and Bluestein) to
    tests/test_torch_mixed_frontend.py's bound between their plain
    versions."""
    rng = np.random.default_rng(4)
    y = torch.from_numpy((rng.standard_normal(500_000) * 0.3).astype(
        np.float32)).to(card)
    mixed = cdsp.launch(y, n_fft, hop, phase, "mixed")
    gemm = cdsp.launch(y, n_fft, hop, phase, "gemm")
    torch.cuda.synchronize()
    mag, ref = (mixed[0], gemm[0]) if phase else (mixed, gemm)
    bound = 4e-6 * ref.abs().max().item()
    torch.testing.assert_close(mag, ref, atol=bound, rtol=0)
    if phase:
        torch.testing.assert_close(mixed[0] * mixed[1], gemm[0] * gemm[1],
                                   atol=bound, rtol=0)


@pytest.mark.cuda
def test_mixed_route_takes_every_plan_kind(card):
    """One launch of each kind the host's plan can make, against the plain
    version: tiny n_fft, Bluestein at L = 32,768 with its planes in the
    device-memory scratch (8193), an odd 7-smooth n_fft packing from the
    signal itself (15625 at hop 16000) and beside its span (hop 4000)."""
    rng = np.random.default_rng(5)
    y = torch.from_numpy((rng.standard_normal(300_000) * 0.3).astype(
        np.float32)).to(card)
    for n_fft, hop in ((2, 1), (3, 2), (11, 4), (32, 8), (8193, 4096),
                       (15625, 16000), (15625, 4000), (16384, 4096)):
        geo = cdsp.mixed_geometry(cdsp.mixed_plan(n_fft), hop)
        x = y[:20_000] if n_fft < 64 else y
        before = _route_counts()
        mag, ri = cdsp.stft_magphase(x, n_fft, hop)
        torch.cuda.synchronize()
        assert _route_counts() == _moved(before, n_fft)
        want_mag, want_ri = cdsp.plain_for(n_fft, True)(x, n_fft, hop)
        torch.testing.assert_close(mag, want_mag, atol=ATOL, rtol=RTOL,
                                   msg=f"n_fft {n_fft} hop {hop} {geo}")
        torch.testing.assert_close(mag * ri, want_mag * want_ri, atol=ATOL,
                                   rtol=0)
        assert torch.equal(cdsp.stft_magnitude(x, n_fft, hop), mag)


@pytest.mark.cuda
def test_fft_route_returns_views_of_padded_rows(card):
    """The fft route pads its output rows to a multiple of 8 frames and
    returns strided views; after ``.contiguous()`` they hold what the CPU
    wrappers return for the same signal (the route's plain version)."""
    rng = np.random.default_rng(3)
    y = (rng.standard_normal(100_001) * 0.3).astype(np.float32)
    mag, ri = cdsp.stft_magphase(torch.from_numpy(y).to(card), 1024, 768)
    only = cdsp.stft_magnitude(torch.from_numpy(y).to(card), 1024, 768)
    torch.cuda.synchronize()
    assert mag.shape == only.shape == (513, 131)      # 131 frames: odd
    assert mag.stride(0) == only.stride(0) == ri.stride(1) == 136
    assert not mag.is_contiguous() and not ri.is_contiguous()
    cpu_mag, cpu_ri = cdsp.stft_magphase(torch.from_numpy(y), 1024, 768)
    assert cpu_mag.is_contiguous() and cpu_ri.is_contiguous()
    dense_mag, dense_ri = mag.contiguous(), ri.contiguous()
    assert torch.equal(dense_mag, mag) and torch.equal(only.contiguous(), mag)
    torch.testing.assert_close(dense_mag.cpu(), cpu_mag, atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close((dense_mag * dense_ri).cpu(),
                               cpu_mag * cpu_ri, atol=ATOL, rtol=0)


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
    # no atomics: both directions give the same bits on every run
    assert torch.equal(dx, cdm.spectral_mag_bwd(x, g, n_fft, hop, win))
    assert torch.equal(mag, cdm.spectral_mag_fwd(x, n_fft, hop, win))


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
    # the partial sums in a fixed order: the same bits from call to call
    assert torch.equal(p, cfl.loss_partials_fwd(x, y, n_fft, hop, win))


# the geometries that stress the wgmma kernels' tiling beyond the train
# resolutions, which the two tests above hold (hop 50 there takes the
# 32-bit fragment loads and the adjoint's N = 56)
TILING_CASES = [
    # (batch, samples, n_fft, hop, win)
    (2, 9_001, 1024, 120, 598),    # odd ``left``: taps from 208, not 213
    (2, 9_001, 512, 120, 512),     # win == n_fft: the whole frame
    (1, 20_000, 2048, 240, 1200),  # B = 1; 84 frames, no whole 64-frame tile
    (2, 1_100, 1024, 120, 600),    # 10 frames: the span meets both pads
    (2, 9_001, 512, 100, 300),     # hop 100: two 64-wide adjoint tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["spectral_mag", "loss_partials"])
@pytest.mark.parametrize("b,t,n_fft,hop,win", TILING_CASES)
def test_backward_kernels_match_plain(card, kind, b, t, n_fft, hop, win):
    """The wgmma backward (gradient GEMM and adjoint) against the plain
    backward at geometries that stress its tiling: one launch each time,
    and the same bits on a repeat."""
    x, y = _waves(card, 6, shape=(b, t))
    geo = (n_fft, hop, win)
    if kind == "spectral_mag":
        n_frames = 1 + t // hop
        g = torch.randn((b, n_fft // 2 + 1, n_frames),
                        generator=torch.Generator(card).manual_seed(7),
                        device=card)
        run = lambda: cdm.spectral_mag_bwd(x, g, *geo)  # noqa: E731
        want = cdm.spectral_mag_bwd_plain(x, g, *geo)
        counts = lambda: (cdm.fwd_launches, cdm.bwd_launches)  # noqa: E731
    else:
        g = torch.tensor([[0.7, 0.0, 1.3], [1.0, 2.0, -0.5],
                          [0.0, 0.0, 1.0]], device=card)[:b]
        run = lambda: cfl.loss_partials_bwd(x, y, g, *geo)  # noqa: E731
        want = cfl.loss_partials_bwd_plain(x, y, g, *geo)
        counts = lambda: (cfl.fwd_launches, cfl.bwd_launches)  # noqa: E731
    before = counts()
    dx = run()
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1] + 1)
    assert dx.shape == (b, t) and bool(torch.isfinite(dx).all())
    _close_grads(dx, want)
    again = run()
    assert counts() == (before[0], before[1] + 2)
    assert torch.equal(dx, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["spectral_mag", "loss_partials"])
@pytest.mark.parametrize("b,t,n_fft,hop,win", TILING_CASES)
def test_forward_kernels_match_plain(card, kind, b, t, n_fft, hop, win):
    """The wgmma forward (the DFT GEMM under the magnitude or the partial
    sums epilogue) against the plain forward at the same geometries: one
    launch each time, and the same bits on a repeat."""
    x, y = _waves(card, 8, shape=(b, t))
    geo = (n_fft, hop, win)
    if kind == "spectral_mag":
        run = lambda: cdm.spectral_mag_fwd(x, *geo)  # noqa: E731
        want = cdm.spectral_mag_plain(x, *geo)
        counts = lambda: (cdm.fwd_launches, cdm.bwd_launches)  # noqa: E731
    else:
        run = lambda: cfl.loss_partials_fwd(x, y, *geo)  # noqa: E731
        want = cfl.loss_partials_plain(x, y, *geo)
        counts = lambda: (cfl.fwd_launches, cfl.bwd_launches)  # noqa: E731
    before = counts()
    got = run()
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1])
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    if kind == "spectral_mag":
        torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-3)
    else:
        torch.testing.assert_close(got, want, atol=0, rtol=1e-4)
    assert torch.equal(got, run())
    assert counts() == (before[0] + 2, before[1])


# ``mr_mag_impl='matmul_bf16'`` on the card: the loss kernels' rounded
# instances (the spectrum stored as bf16 before the power, as the bf16
# matmul's output is) against their rounded plain twin at the train
# resolutions and every tiling case, at the unrounded kernels' bounds; then
# the loss through them against the PyTorch composition it replaces, at
# tests/test_torch_losses.py's matmul_bf16 bounds (1e-3 relative on
# values; gradients max|d|/max|g| < 2e-2, cosine > 0.9999)
ROUNDED_CASES = [(3, 9_001, *r) for r in RESOLUTIONS] + TILING_CASES
PARTIALS_G = [[0.7, 0.0, 1.3], [1.0, 2.0, -0.5], [0.0, 0.0, 1.0]]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,n_fft,hop,win", ROUNDED_CASES)
def test_rounded_loss_partials_kernels_match_plain(card, b, t, n_fft, hop,
                                                   win):
    x, y = _waves(card, 3, shape=(b, t))
    geo = (n_fft, hop, win)
    g = torch.tensor(PARTIALS_G, device=card)[:b]
    before = (cfl.fwd_launches, cfl.bwd_launches)
    p = cfl.loss_partials_fwd(x, y, *geo, rounded=True)
    dx = cfl.loss_partials_bwd(x, y, g, *geo, rounded=True)
    torch.cuda.synchronize()
    assert (cfl.fwd_launches, cfl.bwd_launches) == (before[0] + 1,
                                                   before[1] + 1)
    torch.testing.assert_close(
        p, cfl.loss_partials_plain(x, y, *geo, rounded=True), atol=0,
        rtol=1e-4)
    assert dx.shape == (b, t) and bool(torch.isfinite(dx).all())
    _close_grads(dx, cfl.loss_partials_bwd_plain(x, y, g, *geo,
                                                 rounded=True))
    # the same bits from call to call, and another function than the
    # unrounded instance's
    assert torch.equal(p, cfl.loss_partials_fwd(x, y, *geo, rounded=True))
    assert torch.equal(dx, cfl.loss_partials_bwd(x, y, g, *geo,
                                                 rounded=True))
    assert not torch.equal(p, cfl.loss_partials_fwd(x, y, *geo))


def _loss_route_counts():
    from svs_torch.losses import mrstft as tmr
    return (cfl.fwd_launches, cfl.bwd_launches, tmr.matmul_bf16_fallbacks)


def _value_and_grad(fn, x):
    x = x.detach().clone().requires_grad_()
    out = fn(x)
    out.backward()
    return out.detach(), x.grad


def _close_losses(got, want):
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=1e-3)
    _close_grads(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(32, 768 * 127), (4, 256 * 1535)],
                         ids=["default", "fine_tune"])
def test_matmul_bf16_stft_loss_on_the_card_is_the_composition(card, b, t):
    """At the train cells' patches (B = 32 x 97,536 and 4 x 392,960) each
    resolution's ``stft_loss`` runs the rounded kernels, one launch each
    way and no fallback, and lands on the composition reached directly."""
    from svs_torch.losses import mrstft as tmr
    x, y = _waves(card, 11, shape=(b, t))
    for geo in RESOLUTIONS:
        before = _loss_route_counts()
        got = _value_and_grad(lambda v: tmr.stft_loss(
            v, y, *geo, impl="matmul_bf16"), x)
        torch.cuda.synchronize()
        assert _loss_route_counts() == (before[0] + 1, before[1] + 1,
                                        before[2])
        want = _value_and_grad(lambda v: tmr._composed_loss(
            v, y, *geo, tmr._spectral_mag_matmul, 1.0, 1.0, None, None), x)
        _close_losses(got, want)


@pytest.mark.cuda
def test_weighted_matmul_bf16_on_the_card_is_the_composition(card):
    from svs_torch.losses import mrstft as tmr
    x, y = _waves(card, 12, shape=(3, 9_001))
    w = torch.tensor([1.0, 0.0, 1.0], device=card)
    for geo in RESOLUTIONS:
        before = _loss_route_counts()
        got = _value_and_grad(lambda v: tmr.stft_loss(
            v, y, *geo, impl="matmul_bf16", weight=w), x)
        assert _loss_route_counts() == (before[0] + 1, before[1] + 1,
                                        before[2])
        want = _value_and_grad(lambda v: tmr._composed_loss(
            v, y, *geo, tmr._spectral_mag_matmul, 1.0, 1.0, w, None), x)
        _close_losses(got, want)
        assert not bool(got[1][1].any())  # the zero-weight row


@pytest.mark.cuda
@pytest.mark.parametrize("preset,b", [("default", 32), ("fine_tune", 4)])
def test_matmul_bf16_combined_loss_on_the_card_is_the_composition(
        card, monkeypatch, preset, b):
    """The train step's whole loss at a cell's patches, its gradient with
    respect to the mask: three launches each way, no fallback, and the
    composition's numbers (the route refused by hand)."""
    from svs_torch.losses import mrstft as tmr
    from svs_torch.utils.config import get_config
    cfg = get_config(preset)
    assert cfg.mr_mag_impl == "matmul_bf16"
    rng = np.random.default_rng(13)
    shape = (b, cfg.freq_bins, cfg.input_len)
    mix = rng.random(shape, np.float32)
    planes = [torch.from_numpy(v).to(card) for v in (
        mix, mix * rng.random(shape, np.float32),
        rng.uniform(-3, 3, shape).astype(np.float32),
        rng.uniform(-3, 3, shape).astype(np.float32))]
    mask = torch.from_numpy(rng.random(shape, np.float32)).to(card)

    def loss(m):
        return tmr.combined_loss(m, *planes, cfg)[0]

    before = _loss_route_counts()
    got = _value_and_grad(loss, mask)
    torch.cuda.synchronize()
    assert _loss_route_counts() == (before[0] + 3, before[1] + 3, before[2])
    monkeypatch.setattr(tmr, "_kernels_take", lambda *args: False)
    want = _value_and_grad(loss, mask)
    assert _loss_route_counts() == (before[0] + 3, before[1] + 3, before[2])
    _close_losses(got, want)


@pytest.mark.cuda
def test_matmul_bf16_at_a_perfect_prediction_is_the_composition(card):
    """x == y: every cell a tie, where the rounded instances take the
    composition's subgradient (``abs_like_jax``'s +1), a gradient that is
    not zero."""
    from svs_torch.losses import mrstft as tmr
    x, _ = _waves(card, 15, shape=(2, 9_001))
    for geo in RESOLUTIONS:
        got = _value_and_grad(lambda v: tmr.stft_loss(
            v, x, *geo, impl="matmul_bf16"), x)
        want = _value_and_grad(lambda v: tmr._composed_loss(
            v, x, *geo, tmr._spectral_mag_matmul, 1.0, 1.0, None, None), x)
        assert got[0] == want[0] == 0.0
        assert bool(got[1].any())
        _close_grads(got[1], want[1])


@pytest.mark.cuda
def test_matmul_bf16_falls_back_where_the_kernels_do_not_serve(card):
    """A target that needs a gradient and a float64 prediction take the
    composition on the card, each counted once as a fallback."""
    from svs_torch.losses import mrstft as tmr
    x, y = _waves(card, 14, shape=(2, 9_001))
    geo = (1024, 120, 600)
    cases = [(x, y.clone().requires_grad_()), (x.double(), y.double())]
    for xs, ys in cases:
        before = _loss_route_counts()
        got = tmr.stft_loss(xs, ys, *geo, impl="matmul_bf16")
        assert _loss_route_counts() == (*before[:2], before[2] + 1)
        assert torch.equal(got, tmr._composed_loss(
            xs, ys, *geo, tmr._spectral_mag_matmul, 1.0, 1.0, None, None))


# the geometries past the loss kernels' old limits, which the Pallas
# kernels always took (tests/test_torch_loss_limits.py holds the plain
# versions against those in interpret mode): (batch, samples, n_fft, hop,
# win, what the geometry takes)
WIDENED = [
    (2, 9_001, 64, 16, 64),        # DDSP's smallest scale: 64 zero columns
    (2, 9_001, 1000, 125, 600),    # odd hop (16-bit loads), n_fft % 128
    (2, 9_001, 1024, 121, 600),    # the first odd hop past the old limit
    (3, 9_001, 1026, 120, 600),    # the first n_fft past it: 1152 columns
    (2, 9_001, 129, 33, 100),      # odd n_fft (no Nyquist), odd hop
    (2, 30_000, 1024, 700, 1024),  # loss_partials' spans in pieces
    (2, 60_000, 2048, 1298, 1200),  # spectral_mag's span in pieces too
    (2, 60_000, 2048, 1301, 1200),  # pieces at an odd hop
    (2, 1_100, 2048, 2, 1200),     # 600 shifts in groups of 389
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["spectral_mag", "loss_partials"])
@pytest.mark.parametrize("b,t,n_fft,hop,win", WIDENED)
def test_widened_geometries_match_plain(card, kind, b, t, n_fft, hop, win):
    """Forward and backward of both kernels at each geometry past an old
    limit: one launch each, the plain version's values within the tests'
    bounds, the same bits on a repeat."""
    x, y = _waves(card, 9, shape=(b, t))
    geo = sp.Geometry(b, t, n_fft, hop, win)
    if kind == "spectral_mag":
        g = torch.randn((b, geo.n_bins, geo.n_frames),
                        generator=torch.Generator(card).manual_seed(7),
                        device=card)
        fwd = lambda: cdm.spectral_mag_fwd(x, n_fft, hop, win)  # noqa: E731
        bwd = lambda: cdm.spectral_mag_bwd(x, g, n_fft, hop, win)  # noqa
        want = cdm.spectral_mag_plain(x, n_fft, hop, win)
        want_g = cdm.spectral_mag_bwd_plain(x, g, n_fft, hop, win)
        counts = lambda: (cdm.fwd_launches, cdm.bwd_launches)  # noqa: E731
    else:
        g = torch.tensor([[0.7, 0.0, 1.3], [1.0, 2.0, -0.5],
                          [0.0, 0.0, 1.0]], device=card)[:b]
        fwd = lambda: cfl.loss_partials_fwd(x, y, n_fft, hop, win)  # noqa
        bwd = lambda: cfl.loss_partials_bwd(x, y, g, n_fft, hop, win)  # noqa
        want = cfl.loss_partials_plain(x, y, n_fft, hop, win)
        want_g = cfl.loss_partials_bwd_plain(x, y, g, n_fft, hop, win)
        counts = lambda: (cfl.fwd_launches, cfl.bwd_launches)  # noqa: E731
    before = counts()
    got = fwd()
    dx = bwd()
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    if kind == "spectral_mag":
        torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-3)
    else:
        torch.testing.assert_close(got, want, atol=0, rtol=1e-4)
    assert dx.shape == (b, t) and bool(torch.isfinite(dx).all())
    _close_grads(dx, want_g)
    assert torch.equal(got, fwd()) and torch.equal(dx, bwd())


@pytest.mark.cuda
def test_shared_memory_mirror_matches_the_cuda_formulas(card):
    """spectral.py's dft_staging / adj_group / adj_smem, which check_card
    reads, give the staging and the bytes the C++ launches take
    (svs_dft_pieces, svs_dft_smem, svs_adj_group, svs_adj_smem)."""
    lib = build.load(cdm.KERNEL)
    for fn in (lib.svs_dft_pieces, lib.svs_dft_smem, lib.svs_adj_group,
               lib.svs_adj_smem):
        fn.restype = ctypes.c_int
    for n_taps in (64, 256, 640, 1216, 2048):
        for hop in range(1, 1400):
            for nsig in (1, 2):
                how, smem = sp.dft_staging(nsig, hop, n_taps)
                assert lib.svs_dft_pieces(nsig, hop, n_taps) == (
                    how == "pieces"), (nsig, hop, n_taps)
                assert lib.svs_dft_smem(nsig, hop, n_taps) == smem
                assert smem <= sp.SMEM_LIMIT
    for width in (56, 64, 120, 240):
        for k in range(1, 2100):
            group = sp.adj_group(width, k)
            assert lib.svs_adj_group(width, k) == group
            assert lib.svs_adj_smem(width, k) == sp.adj_smem(width, group)
            assert sp.adj_smem(width, group) <= sp.SMEM_LIMIT


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


# ---------------------------------------------------------------- epoch_scan
# The whole-epoch training of train/scan.py: a captured CUDA graph of the
# step, replayed, against the eager step on the same card.  Both run the
# same kernels and the same Adam (its capturable form, as fit builds it
# on the card), and the bf16 step is
# deterministic on the H100, so they agree to the bit there; the bounds
# are the acceptance's: the per-step losses within 1e-5 relative and the
# parameters within __graft_entry__.py's envelope (max |d| <= 2.1 lr, mean
# |d| < 2e-4).

SCAN_B, SCAN_STEPS = 4, 4


def _scan_setup(card, impl, dropout=0.5, accum=1):
    import dataclasses

    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config

    cfg = dataclasses.replace(get_config("default"), mr_mag_impl=impl,
                              dropout_rate=dropout)
    gen = torch.Generator().manual_seed(5)
    planes = {k: torch.rand((2, 512, 300), generator=gen).to(card)
              for k in ("mix", "voc", "mix_angle", "voc_angle")}
    rng = np.random.default_rng(0)
    songs = rng.integers(0, 2, (SCAN_STEPS, SCAN_B)).astype(np.int32)
    starts = rng.integers(0, 300 - 128, (SCAN_STEPS, SCAN_B)).astype(np.int32)
    opt = tstep.make_optimizer(cfg, accum)
    return cfg, planes, songs, starts, [
        tstep.create_train_state(0, cfg, opt, device=card) for _ in range(2)]


def _eager_epoch(cfg, state, planes, songs, starts, gen):
    from svs_torch.data.device_data import gather_crops
    from svs_torch.train import step as tstep
    step = tstep.make_step_fn(cfg)
    losses = []
    dev = planes["mix"].device
    for s, st in zip(songs, starts):
        batch = gather_crops(
            planes, torch.as_tensor(s, dtype=torch.int64, device=dev),
            torch.as_tensor(st, dtype=torch.int64, device=dev), cfg.input_len)
        state, m = step(state, batch, gen)
        losses.append(m["total"])
    return torch.stack(losses)


def _close_states(a, b, lr):
    d = torch.cat([(p - q).abs().flatten() for p, q in
                   zip(a.model.parameters(), b.model.parameters())])
    assert d.max().item() <= 2.1 * lr and d.mean().item() < 2e-4, (
        d.max().item(), d.mean().item())


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["matmul_bf16", "pallas_bf16",
                                  "pallas_fused"])
def test_graph_replay_matches_the_eager_step(card, impl):
    from svs_torch.train import scan as tscan
    cfg, planes, songs, starts, (eager, graphed) = _scan_setup(card, impl)
    want = _eager_epoch(cfg, eager, planes, songs, starts,
                        torch.Generator(card).manual_seed(1))
    epoch = tscan.make_epoch_scan(cfg)
    cdm.reset_counts()
    cfl.reset_counts()
    graphed, got = epoch(graphed, planes, songs, starts,
                         torch.Generator(card).manual_seed(1))
    assert graphed.step == eager.step == SCAN_STEPS
    assert epoch.captures == 1 and len(epoch.graphs) == 1
    # the wrappers launch for the eager warm-up step and record once in
    # the capture (matmul_bf16: the loss kernels' rounded instances)
    per_step = {"matmul_bf16": (0, 0, 3, 3), "pallas_bf16": (6, 3, 0, 0),
                "pallas_fused": (0, 0, 3, 3)}[impl]
    assert (cdm.fwd_launches, cdm.bwd_launches, cfl.fwd_launches,
            cfl.bwd_launches) == per_step
    assert (cdm.fwd_captured, cdm.bwd_captured, cfl.fwd_captured,
            cfl.bwd_captured) == per_step
    assert epoch.replays == SCAN_STEPS - 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    _close_states(eager, graphed, cfg.learning_rate)


@pytest.mark.cuda
def test_replays_draw_the_eager_steps_dropout_masks(card):
    """A generator registered with the graph: each replay draws fresh
    masks, the same the eager draws take from the same generator state."""
    from svs_torch.models.unet import dropout_keep
    shape = (8, 64, 32, 16)
    eager_gen = torch.Generator(card).manual_seed(7)
    want = [dropout_keep(shape, 0.5, card, eager_gen) for _ in range(3)]
    gen = torch.Generator(card).manual_seed(7)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = dropout_keep(shape, 0.5, card, gen)
    got = []
    for _ in range(3):
        graph.replay()
        got.append(out.clone())
    assert not torch.equal(got[0], got[1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert gen.get_offset() == eager_gen.get_offset()


@pytest.mark.cuda
def test_graph_is_captured_again_after_a_learning_rate_change(card):
    from svs_torch.train import scan as tscan
    from svs_torch.train import step as tstep
    cfg, planes, songs, starts, (eager, graphed) = _scan_setup(
        card, "pallas_fused", dropout=0.0)
    epoch = tscan.make_epoch_scan(cfg)
    eg, gg = (torch.Generator(card).manual_seed(1) for _ in range(2))
    want, got = [], []
    for lr in (cfg.learning_rate, cfg.lr_after_drop):
        tstep.set_learning_rate(eager, lr)
        tstep.set_learning_rate(graphed, lr)
        want.append(_eager_epoch(cfg, eager, planes, songs, starts, eg))
        graphed, losses = epoch(graphed, planes, songs, starts, gg)
        got.append(losses)
    assert epoch.captures == 2
    torch.testing.assert_close(torch.cat(got), torch.cat(want), rtol=1e-5,
                               atol=0)
    _close_states(eager, graphed, cfg.learning_rate)


@pytest.mark.cuda
def test_accumulation_graphs_match_the_eager_cycle(card):
    """accum_steps = 2: one graph per cycle position on static buffers."""
    from svs_torch.train import scan as tscan
    cfg, planes, songs, starts, (eager, graphed) = _scan_setup(
        card, "matmul_bf16", accum=2)
    want = _eager_epoch(cfg, eager, planes, songs, starts,
                        torch.Generator(card).manual_seed(1))
    epoch = tscan.make_epoch_scan(cfg)
    graphed, got = epoch(graphed, planes, songs, starts,
                         torch.Generator(card).manual_seed(1))
    assert sorted(epoch.graphs) == [0, 1]
    assert graphed.mini_step == eager.mini_step == 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    _close_states(eager, graphed, cfg.learning_rate)


@pytest.mark.cuda
def test_cuda_adam_is_capturable_by_default(card):
    """Since the step programs (``train/graphs.py``) every CUDA state needs
    it: Adam on the card is the capturable form (``fit`` builds it on
    every path), on the CPU the host form."""
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config
    cfg = get_config("default")
    p = [torch.zeros(4, device=card, requires_grad=True)]
    assert tstep.make_optimizer(cfg).build(p).param_groups[0]["capturable"]
    assert not tstep.make_optimizer(cfg).build(
        [torch.zeros(4, requires_grad=True)]).param_groups[0]["capturable"]


@pytest.mark.cuda
def test_capturable_adam_checkpoint_round_trip(card, tmp_path):
    """A checkpoint of a graph-trained state loads into a capturable Adam
    with its step counts on the card, writes back the same bytes, and the
    loaded state trains on under the graph."""
    from svs_torch.train import checkpoint as ckpt
    from svs_torch.train import scan as tscan
    cfg, planes, songs, starts, (first, second) = _scan_setup(
        card, "pallas_bf16", dropout=0.0)
    first, _ = tscan.make_epoch_scan(cfg)(
        first, planes, songs, starts, torch.Generator(card).manual_seed(1))
    path = str(tmp_path / "a.ckpt")
    ckpt.save(path, first, epoch=1)
    assert second.optimizer.param_groups[0]["capturable"]
    ckpt.load(path, second)
    steps = {st["step"].device.type for st in second.optimizer.state.values()}
    assert steps == {"cuda"}
    again = str(tmp_path / "b.ckpt")
    ckpt.save(again, second, epoch=1)
    with open(path, "rb") as f, open(again, "rb") as g:
        assert f.read() == g.read()
    second, losses = tscan.make_epoch_scan(cfg)(
        second, planes, songs, starts, torch.Generator(card).manual_seed(2))
    assert second.step == 2 * SCAN_STEPS and torch.isfinite(losses).all()


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [False, True], ids=["plain", "forced"])
def test_world_of_one_mesh_graph_epoch_is_the_single_graph_epoch(card,
                                                                  forced):
    """A world of one over NCCL: the mesh epoch's replays (plainly, and
    with the step's collectives forced on: NCCL's all-reduces of one rank
    recorded into the graph) give the losses and state of the
    single-device graph epoch of the same batches with the all-ones
    ``weight`` that ``shard_batch`` appends, bit for bit (``pallas_fused``,
    dropout on, bf16 convs, cuDNN deterministic)."""
    import contextlib

    import torch.distributed as dist

    import chip_smoke
    from svs_torch.parallel import dp
    from svs_torch.parallel import mesh as mesh_lib
    from svs_torch.train import scan as tscan

    cfg, planes, songs, starts, (single, meshed) = _scan_setup(
        card, "pallas_fused")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh = mesh_lib.make_mesh()
    try:
        with chip_smoke.weighted_single():
            single, want = tscan.make_epoch_scan(cfg)(
                single, planes, songs, starts,
                torch.Generator(card).manual_seed(1))
        with (chip_smoke.forced_collectives() if forced
              else contextlib.nullcontext()):
            epoch = tscan.make_epoch_scan(cfg, mesh=mesh)
            meshed, got = epoch(meshed, planes, songs, starts,
                                torch.Generator(card).manual_seed(1))
            torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = was
    assert epoch.captures == 1 and epoch.replays == SCAN_STEPS - 1
    assert torch.equal(got, want)
    for a, b in zip(dp._state_tensors(single), dp._state_tensors(meshed)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_world_of_one_sharded_steps_are_make_train_steps_bits(card):
    """A world of one over NCCL: the ZeRO-1 and FSDP steps under
    ``pallas_fused`` (dropout on, bf16 convs, cuDNN deterministic) are
    ``make_train_step``'s bits, Adam's moments included, and launch the
    loss kernels as it does."""
    import torch.distributed as dist

    from svs_torch.parallel import dryrun
    from svs_torch.parallel import mesh as mesh_lib
    from svs_torch.utils.config import SVSConfig

    cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16), input_len=128,
                    mr_mag_impl="pallas_fused", compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    mix = rng.random((4, 512, 128)).astype(np.float32)
    batch = {"mix": mix, "voc": mix * 0.5,
             "mix_angle": rng.uniform(-3, 3, mix.shape).astype(np.float32),
             "voc_angle": rng.uniform(-3, 3, mix.shape).astype(np.float32)}
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh = mesh_lib.make_mesh()
    try:
        assert mesh.size == 1 and mesh.backend == "nccl"
        r = dryrun.layout_parity(mesh, cfg, batch)
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = was
    for kind in ("zero1", "fsdp"):
        x = r[kind]
        assert all(x[k] == 0.0 for k in ("loss_rel", "grad_norm_rel",
                                         "bn_abs", "params_max")), (kind, x)
        assert x["vs_dp"] == 0.0 and x["shards_ok"], (kind, x)
        assert tuple(x["kernels"]) == (0, 0, 3, 3), (kind, x)


@pytest.mark.cuda
def test_world_of_one_tp_step_is_make_train_steps_bits(card):
    """A (1, 1) mesh over NCCL: the TP step under ``pallas_bf16`` (dropout
    on, bf16 convs, cuDNN deterministic) is ``make_train_step``'s bits,
    Adam's moments included, and launches the loss kernels as it does."""
    import torch.distributed as dist

    from svs_torch.parallel import dryrun
    from svs_torch.parallel import mesh as mesh_lib
    from svs_torch.utils.config import SVSConfig

    cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16), input_len=128,
                    mr_mag_impl="pallas_bf16", compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    mix = rng.random((4, 512, 128)).astype(np.float32)
    batch = {"mix": mix, "voc": mix * 0.5,
             "mix_angle": rng.uniform(-3, 3, mix.shape).astype(np.float32),
             "voc_angle": rng.uniform(-3, 3, mix.shape).astype(np.float32)}
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh = mesh_lib.make_2d_mesh(1, 1)
    try:
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.backend == "nccl"
        x = dryrun.layout_parity(mesh, cfg, batch, ("dp", "tp"))["tp"]
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = was
    assert all(x[k] == 0.0 for k in ("loss_rel", "grad_norm_rel", "bn_abs",
                                     "params_max")), x
    assert x["vs_dp"] == 0.0 and x["shards_ok"], x
    assert tuple(x["kernels"]) == (6, 3, 0, 0), x


@pytest.mark.cuda
@pytest.mark.parametrize("impl,counts", [("pallas_fused", (0, 0, 3, 3)),
                                         ("pallas_bf16", (6, 3, 0, 0))])
def test_one_card_pp_step_is_make_train_steps_bits(card, impl, counts):
    """Both stages on ``cuda:0``: the one-microbatch PP step (dropout on,
    bf16 convs, cuDNN deterministic) is ``make_train_step``'s bits and
    launches the loss kernels inside it as that step does."""
    from svs_torch.parallel import dryrun
    from svs_torch.utils.config import SVSConfig

    cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16), input_len=128,
                    mr_mag_impl=impl, compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    mix = rng.random((4, 512, 128)).astype(np.float32)
    batch = {"mix": mix, "voc": mix * 0.5,
             "mix_angle": rng.uniform(-3, 3, mix.shape).astype(np.float32),
             "voc_angle": rng.uniform(-3, 3, mix.shape).astype(np.float32)}
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        r = dryrun.pp_parity(("cuda:0", "cuda:0"), cfg, batch, n_micro=1)
    finally:
        torch.backends.cudnn.deterministic = was
    assert r["ok"] and r["bits"] == 0.0, r
    assert tuple(r["kernels"]) == counts, r


@pytest.mark.cuda
@pytest.mark.parametrize("impl,counts", [("pallas_fused", (0, 0, 3, 3)),
                                         ("pallas_bf16", (6, 3, 0, 0))])
def test_world_of_one_cp_step_and_decode(card, impl, counts):
    """A world of one over NCCL: the CP step (the halo arithmetic as a
    zero pad and valid convs; dropout on, bf16 convs, remat, cuDNN
    deterministic) is within the dry run's envelope of
    ``make_train_step`` and launches the loss kernels inside it as that
    step does; the whole-song CP decode of a 1024-frame song (float32,
    which both decodes pad alike) is the unsharded whole decode, and the
    unsharded forward at CP's padding, within 3e-5."""
    import torch.distributed as dist

    from svs_torch.parallel import dryrun
    from svs_torch.parallel import mesh as mesh_lib
    from svs_torch.utils.config import SVSConfig

    cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16), input_len=256,
                    mr_mag_impl=impl, compute_dtype="bfloat16", remat=True)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    mesh = mesh_lib.make_mesh()
    try:
        assert mesh.size == 1 and mesh.backend == "nccl"
        r = dryrun.cp_parity(mesh, cfg, dryrun.dry_batch(4, 256))
        song = np.random.default_rng(1).random((513, 1000), np.float32)
        d = dryrun.cp_decode_parity(
            mesh, SVSConfig(enc_channels=cfg.enc_channels), song)
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = was
    assert r["ok"] and r["spread"] == 0.0, r
    assert tuple(r["kernels"]) == counts, r
    assert max(d["max_abs_err"], d["padded_err"]) <= 3e-5, d


@pytest.mark.cuda
def test_two_one_rank_hosts_take_a_dp_step_on_the_card(card):
    """Two hosts of one rank each, both on ``cuda:0`` over gloo (NCCL
    refuses two ranks on one card), float32 with TF32 off: each host's
    share of a batch of 5 (3 and 2 rows, padded to 3) through one DP step
    within the dry run's envelope of ``make_train_step`` on the host-major
    padded batch with its ``weight``, the ranks the same bits, and the
    loss kernels launched inside the step under ``pallas_fused`` and
    ``pallas_bf16``."""
    from svs_torch.parallel import dryrun
    from svs_torch.parallel.launch import Ranks
    from svs_torch.utils.config import SVSConfig

    with Ranks(2, device="cuda:0", backend="gloo", hosts=2,
               timeout=300) as ranks:
        ranks.run(dryrun.no_tf32)
        for impl, counts in (("pallas_fused", (0, 0, 3, 3)),
                             ("pallas_bf16", (6, 3, 0, 0))):
            cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16),
                            input_len=128, mr_mag_impl=impl,
                            compute_dtype="float32")
            r = ranks.run(dryrun.mh_parity, cfg, dryrun.dry_batch(5, 128))[0]
            assert r["ok"] and r["spread"] == 0.0, r
            assert r["rows"] == [3, 2] and r["pad_to"] == 3, r
            assert tuple(r["kernels"]) == counts, r


# -- the decode's cached programs (svs_torch/infer/graphs.py) ---------------

def _decode_model(card, dtype="float32"):
    from svs_torch.models.unet import UNet
    from svs_torch.utils.config import SVSConfig
    cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16), compute_dtype=dtype)
    return UNet(cfg, generator=torch.Generator().manual_seed(0)).to(
        card).eval()


def _song(seconds, seed, pcm16=False):
    y = (np.random.default_rng(seed).standard_normal(int(8192 * seconds))
         * 0.1).astype(np.float32)
    return (y * 32768.0).clip(-32768, 32767).astype(np.int16) if pcm16 else y


def _eager_decode(model, y, *, vocal_solo=True, both=False, mode="segments",
                  pcm16=False):
    """The eager body on the padded song on the card, cut to the song."""
    from svs_torch.infer import separate
    cfg, n = model.cfg, len(y)
    y_p = torch.from_numpy(np.pad(y, (0, separate._padded_len(n, cfg) - n)))
    with torch.inference_mode():
        y_p = y_p.to(next(model.parameters()).device)
        if pcm16:
            out = (separate._separate_padded_pcm16(model, y_p, cfg,
                                                   vocal_solo, mode),)
        else:
            out = separate._separate_padded(model, y_p, cfg, vocal_solo,
                                            both, mode)
            out = out if both else (out,)
    outs = tuple(o[:n].cpu().numpy() for o in out)
    return outs if both else outs[0]


@pytest.fixture
def decode_cache(card, monkeypatch):
    """A fresh cache of programs, cuDNN deterministic: float32 cuDNN
    convs are not the same bits run to run on the H100 (two eager calls of
    the narrow or the ``default`` model differed by ~4e-8 with TF32 on or
    off, while bf16 and deterministic algorithms gave equal bits, eager or
    replayed), so without it the eager oracle does not repeat itself."""
    from svs_torch.infer import graphs
    cache = graphs.ProgramCache()
    monkeypatch.setattr(graphs, "CACHE", cache)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return cache


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["segments", "overlap", "whole"])
def test_decode_replays_are_the_eager_bits(card, decode_cache, mode, dtype):
    """Each program's replay equals the eager body bit for bit: the wav
    decode with ``vocal_solo`` on and off, ``both=True``, PCM16 (0 LSB) and
    the magnitude decode; each key captured once, its second call a
    replay."""
    from svs_torch.infer import separate
    model = _decode_model(card, dtype)
    y = _song(7.3, 1)
    for _ in range(2):
        for vocal_solo in (True, False):
            got = separate.separate_wav(model, y, vocal_solo=vocal_solo,
                                        mode=mode)
            np.testing.assert_array_equal(
                got, _eager_decode(model, y, vocal_solo=vocal_solo,
                                   mode=mode))
        got = separate.separate_wav(model, y, both=True, mode=mode)
        for g, w in zip(got, _eager_decode(model, y, both=True, mode=mode)):
            np.testing.assert_array_equal(g, w)
        y16 = _song(7.3, 2, pcm16=True)
        (got,) = separate.separate_wav_stream(model, [y16], pcm16=True,
                                              mode=mode)
        assert got.dtype == np.int16
        np.testing.assert_array_equal(
            got, _eager_decode(model, y16, mode=mode, pcm16=True))
        mag = np.random.default_rng(3).random((513, 300), np.float32)
        got = separate.separate_magnitude(model, mag, mode=mode)
        with torch.inference_mode():
            m = torch.from_numpy(np.pad(mag, ((0, 0), (0, 1024 - 300))))
            want = separate._separate_spec(model, m.to(card), model.cfg,
                                           True, mode)[:, :300].cpu().numpy()
        np.testing.assert_array_equal(got, want)
    assert decode_cache.builds == len(decode_cache) == 5


@pytest.mark.cuda
@pytest.mark.parametrize("pcm16", [False, True])
def test_interleaved_stream_of_two_lengths_is_the_eager_decode(
        card, decode_cache, pcm16):
    """The stream's overlap (song i+1's copy in and replay enqueued while
    song i's copy out runs) over songs of two buckets, interleaved: each
    song is the eager body's, and each bucket's program is captured
    once."""
    from svs_torch.infer import separate
    model = _decode_model(card)
    songs = [_song(s, i, pcm16) for i, s in enumerate((10, 40, 12, 35, 9))]
    got = separate.separate_wav_stream(model, songs, pcm16=pcm16,
                                       mode="overlap")
    for y, o in zip(songs, got):
        assert o.shape == y.shape
        np.testing.assert_array_equal(
            o, _eager_decode(model, y, mode="overlap", pcm16=pcm16))
    assert decode_cache.builds == 2


@pytest.mark.cuda
def test_a_failed_capture_raises(card, decode_cache, monkeypatch):
    """No fallback: a body that fails while it is captured makes the call
    raise, and no program of its key is kept."""
    from svs_torch.infer import separate
    real = separate._separate_padded

    def failing(*args, **kwargs):
        out = real(*args, **kwargs)
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the body cannot be captured")
        return out

    monkeypatch.setattr(separate, "_separate_padded", failing)
    model = _decode_model(card)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        separate.separate_wav(model, _song(3, 0))
    assert len(decode_cache) == 0
    monkeypatch.setattr(separate, "_separate_padded", real)
    y = _song(3, 0)
    np.testing.assert_array_equal(separate.separate_wav(model, y),
                                  _eager_decode(model, y))


@pytest.mark.cuda
def test_a_rebound_model_is_captured_again(card, decode_cache):
    """New tensors (``load_state_dict(assign=True)``) mean a new program:
    the old tensors stay alive here, so a stale replay would give the old
    weights' answer."""
    from svs_torch.infer import separate
    model = _decode_model(card)
    y = _song(5, 4)
    old_sd = model.state_dict()
    before = separate.separate_wav(model, y)
    model.load_state_dict({k: v * 0.5 if v.is_floating_point() else v
                           for k, v in old_sd.items()}, assign=True)
    got = separate.separate_wav(model, y)
    assert decode_cache.builds == 2 and len(decode_cache) == 1
    np.testing.assert_array_equal(got, _eager_decode(model, y))
    assert not np.array_equal(got, before)


@pytest.mark.cuda
def test_serve_warmup_leaves_its_program_captured(card, decode_cache):
    """``serve(warmup_secs > 0)`` captures the warm-up length's program on
    its worker thread, so a first request of that bucket replays it."""
    from svs_torch.serve import server
    model = _decode_model(card)
    httpd = server.serve(model, port=0, warmup_secs=4.0)
    try:
        assert decode_cache.builds == 1
        ((_, signature, *_),) = decode_cache._programs
        assert signature == ("wav", server.DEFAULT_MODE, True, False, False)
        y = _song(6, 5)
        got = httpd.service.separate(y, mode=server.DEFAULT_MODE)
        assert decode_cache.builds == 1
        np.testing.assert_array_equal(
            got, _eager_decode(model, y, mode=server.DEFAULT_MODE))
    finally:
        server.close(httpd, 30)


# ------------------------------------------------------------- step programs
# ``make_train_step`` / ``make_eval_step`` on the card: a cached captured
# program per key (``train/graphs.py``).  A replay runs the eager body's
# kernels in its order on the same Adam (capturable), so the state and the
# metrics are the eager body's bits (bf16 convs, cuDNN deterministic).


@pytest.fixture
def step_cache(card, monkeypatch):
    """A fresh cache of step programs, cuDNN's deterministic algorithms."""
    from svs_torch.train import graphs
    cache = graphs.infer_graphs.ProgramCache(graphs.MAX_BYTES)
    monkeypatch.setattr(graphs, "CACHE", cache)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    yield cache
    cache.clear()


def _step_states(card, impl, accum=1):
    import dataclasses

    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config
    cfg = dataclasses.replace(get_config("default"), mr_mag_impl=impl)
    opt = tstep.make_optimizer(cfg, accum)
    return cfg, [tstep.create_train_state(0, cfg, opt, device=card)
                 for _ in range(2)]


def _step_batch(card, seed, b=SCAN_B):
    rng = np.random.default_rng(seed)
    shape = (b, 512, 128)
    mix = rng.random(shape, np.float32)
    host = {"mix": mix, "voc": mix * rng.random(shape, np.float32),
            "mix_angle": rng.uniform(-3, 3, shape).astype(np.float32),
            "voc_angle": rng.uniform(-3, 3, shape).astype(np.float32)}
    return {k: torch.from_numpy(v).to(card) for k, v in host.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["matmul_bf16", "pallas_bf16",
                                  "pallas_fused"])
def test_step_program_replays_are_the_eager_bits(card, step_cache, impl):
    """Four calls (dropout on) against four eager steps: the warm-up call,
    one capture, three replays; the same metrics and state bits, the
    tail's program and the eval programs too."""
    from svs_torch.parallel import dp
    from svs_torch.train import step as tstep
    cfg, (eager, prog) = _step_states(card, impl)
    eager_step, prog_step = tstep.make_step_fn(cfg), tstep.make_train_step(cfg)
    ge, gp = (torch.Generator(card).manual_seed(1) for _ in range(2))
    for i, b in enumerate((SCAN_B,) * 4 + (3, 3)):
        batch = _step_batch(card, i, b)
        eager, want = eager_step(eager, batch, ge)
        prog, got = prog_step(prog, batch, gp)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    assert prog.step == eager.step == 6
    for a, b in zip(dp._state_tensors(eager), dp._state_tensors(prog)):
        assert torch.equal(a, b)
    full, tail = step_cache._programs.values()
    assert (full.captures, full.replays) == (1, 3)
    assert (tail.captures, tail.replays) == (1, 1)
    assert full.pool_bytes > 0 and full.graphs is not None
    for b in (SCAN_B, 3):
        batch = _step_batch(card, 10, b)
        for _ in range(2):
            got = tstep.make_eval_step(cfg)(prog, batch)
            want = tstep.make_eval_fn(cfg)(eager, batch)
            for k in want:
                assert torch.equal(got[k], want[k]), (b, k)


@pytest.mark.cuda
def test_step_program_refuses_a_host_form_adam(card, step_cache):
    from svs_torch.train import step as tstep
    cfg, (state, _) = _step_states(card, "matmul_bf16")
    # the host form, built directly (make_optimizer's is capturable here)
    state.optimizer = torch.optim.Adam(state.model.parameters(),
                                       lr=cfg.learning_rate)
    with pytest.raises(ValueError, match="capturable"):
        tstep.make_train_step(cfg)(state, _step_batch(card, 0),
                                   torch.Generator(card).manual_seed(1))
    assert state.step == 0 and not state.optimizer.state


@pytest.mark.cuda
def test_a_failed_step_capture_raises(card, step_cache, monkeypatch):
    """No fallback: a step that fails while it is captured makes the call
    raise (the first call, the eager warm-up, ran), and so does the next
    call, which captures again."""
    from svs_torch.train import step as tstep
    real = tstep.loss_and_grads

    def failing(*args, **kwargs):
        out = real(*args, **kwargs)
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the step cannot be captured")
        return out

    monkeypatch.setattr(tstep, "loss_and_grads", failing)
    cfg, (state, _) = _step_states(card, "matmul_bf16")
    step, gen = tstep.make_train_step(cfg), torch.Generator(card)
    step(state, _step_batch(card, 0), gen)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="cannot be captured"):
            step(state, _step_batch(card, 1), gen)
    assert state.step == 1


@pytest.mark.cuda
def test_step_program_captures_again_after_a_rate_change_and_a_restore(
        card, step_cache, tmp_path):
    """The learning-rate drop and a checkpoint restore (a fresh Adam state
    in its capturable form) each capture again; the state stays the eager
    body's, with accumulation over 2."""
    from svs_torch.parallel import dp
    from svs_torch.train import checkpoint as ckpt
    from svs_torch.train import step as tstep
    cfg, (eager, prog) = _step_states(card, "pallas_fused", accum=2)
    eager_step, prog_step = tstep.make_step_fn(cfg), tstep.make_train_step(cfg)
    ge, gp = (torch.Generator(card).manual_seed(1) for _ in range(2))
    path = str(tmp_path / "s.ckpt")
    for i in range(8):
        if i == 4:
            for s in (eager, prog):
                tstep.set_learning_rate(s, cfg.lr_after_drop)
        if i == 6:
            for s in (eager, prog):
                ckpt.save(path, s, epoch=1)
                ckpt.load(path, s)
        batch = _step_batch(card, i)
        eager, want = eager_step(eager, batch, ge)
        prog, got = prog_step(prog, batch, gp)
        assert torch.equal(got["total"], want["total"]), i
    (program,) = step_cache._programs.values()
    assert program.captures == 3 and sorted(program.graphs) == [0, 1]
    for a, b in zip(dp._state_tensors(eager), dp._state_tensors(prog)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas_bf16", "pallas_fused"])
def test_world_of_one_layout_programs_are_their_eager_bodies(
        card, step_cache, impl):
    """A world of one over NCCL (and the (1, 1) mesh for TP): the DP,
    ZeRO-1, FSDP, CP and TP steps run as programs (warm-up, capture,
    replay), each the bits of its eager body (``step.eager``: metrics,
    parameters, BN and Adam's moments), bf16 convs, cuDNN deterministic,
    dropout on."""
    import torch.distributed as dist

    from svs_torch.parallel import dryrun
    from svs_torch.parallel import mesh as mesh_lib
    from svs_torch.train import graphs
    from svs_torch.utils.config import SVSConfig

    cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16), input_len=128,
                    mr_mag_impl=impl, compute_dtype="bfloat16")
    batch = dryrun.dry_batch(4, 128)
    out = {}
    for kinds, make in ((("dp", "zero1", "fsdp", "cp"), mesh_lib.make_mesh),
                        (("tp",), lambda: mesh_lib.make_2d_mesh(1, 1))):
        mesh = make()
        try:
            assert mesh.backend == "nccl" and graphs.mesh_programmed(mesh)
            for kind in kinds:
                out[kind] = dryrun.program_parity(
                    kind, cfg, mesh,
                    [dryrun.layout_batch(kind, mesh, batch)] * 3)
        finally:
            step_cache.clear()
            dist.destroy_process_group()
    for kind, r in out.items():
        assert r["programmed"] and r["vs_eager"] == 0.0, (kind, r)
        assert r["programs"] == [(1, 2)], (kind, r)


# -- PP's steps and the SP and CP decodes as programs -----------------------

@pytest.fixture
def program_caches(step_cache, monkeypatch):
    """Fresh caches of step and decode programs, cuDNN's deterministic
    algorithms and TF32 off (the checks are bit for bit, float32 too)."""
    from svs_torch.infer import graphs as infer_graphs
    cache = infer_graphs.ProgramCache()
    monkeypatch.setattr(infer_graphs, "CACHE", cache)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    yield step_cache, cache
    cache.clear()


def _pp_batches(n):
    """A full batch of 8 and a tail of 5 padded to 8 (at 4 microbatches
    its last one empty), alternating over ``n`` calls."""
    from svs_torch.parallel import dryrun, pp
    full = dryrun.dry_batch(8, 128)
    tail = pp.pad_batch({k: v[:5] for k, v in dryrun.dry_batch(
        8, 128).items()}, 8)
    return [full if i % 2 == 0 else tail for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_micro,impl", [(1, "pallas_fused"),
                                          (4, "pallas_bf16")])
def test_one_card_pp_programs_are_their_eager_bodies(card, program_caches,
                                                     n_micro, impl):
    """Both stages on ``cuda:0``: PP's train step as programs (a full batch
    and a ragged tail, each a warm-up, a capture and replays; dropout on,
    at 4 microbatches from the re-seeded generators registered with the
    graphs) is its eager body's bits, metrics, parameters, BN, Adam's
    moments and the generator's state; the eval programs the eager
    eval's bits."""
    from svs_torch.parallel import dryrun, pp
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import SVSConfig

    cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16), input_len=128,
                    mr_mag_impl=impl, compute_dtype="bfloat16")
    devs = ("cuda:0", "cuda:0")
    assert pp.programmed(devs)
    r = dryrun.pp_program_parity(devs, cfg, _pp_batches(5),
                                 n_micro=n_micro)
    assert r["programmed"] and r["vs_eager"] == 0.0, r
    assert sorted(r["programs"]) == [(1, 1), (1, 2)], r
    state = pp.shard_state(tstep.create_train_state(0, cfg, device=card),
                           pp.make_pp_mesh(devs))
    evaluate = pp.make_pp_eval_step(devs, cfg)
    for batch in _pp_batches(2) * 2:
        got, want = evaluate(state, batch), evaluate.eager(state, batch)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_two_one_card_pp_steps_share_their_programs(card, program_caches):
    """Two four-microbatch PP steps over one model on ``cuda:0``, dropout
    on, called in turns with one generator: their programs are shared
    (each seeds its own generators from the call's generator before the
    replay), and the state and the generator are the eager steps' bits."""
    from svs_torch.parallel import dryrun, pp
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import SVSConfig

    steps_cache, _ = program_caches
    cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16), input_len=128,
                    mr_mag_impl="pallas_fused", compute_dtype="bfloat16")
    devs = pp.make_pp_mesh(("cuda:0", "cuda:0"))
    got = {}
    for form in ("program", "eager"):
        state = pp.shard_state(tstep.create_train_state(0, cfg, device=card),
                               devs)
        steps = [pp.make_pp_train_step(devs, cfg, n_micro=4)
                 for _ in range(2)]
        if form == "eager":
            steps = [s.eager for s in steps]
        gen = torch.Generator(card).manual_seed(1)
        metrics = [steps[i % 2](state, b, gen)[1]
                   for i, b in enumerate(_pp_batches(6))]
        got[form] = (metrics, dryrun._full(pp.gather_state(state)),
                     gen.get_state())
    (pm, pf, pg), (em, ef, eg) = got["program"], got["eager"]
    for a, b in zip(pm, em):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert max(dryrun._max_diff(pf[k], ef[k]) for k in ("sd", "mu", "nu")) \
        == 0.0
    assert torch.equal(pg, eg) and steps_cache.builds == 2


@pytest.mark.cuda
def test_pp_over_two_distinct_devices_runs_the_eager_step(card,
                                                          program_caches):
    """``pp.programmed`` refuses two distinct devices, decided before any
    step: the stages on ``cuda:0`` and the host run the eager step, and
    no program is built."""
    from svs_torch.parallel import pp
    from svs_torch.train import graphs
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import SVSConfig

    steps, _ = program_caches
    assert not graphs.stages_programmed((torch.device("cuda", 0),
                                         torch.device("cuda", 1)))
    devs = ("cuda:0", "cpu")
    assert not pp.programmed(devs) and pp.programmed(("cuda:0", "cuda:0"))
    cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16), input_len=128,
                    mr_mag_impl="fft")
    state = pp.shard_state(tstep.create_train_state(0, cfg, device=card),
                           pp.make_pp_mesh(devs), split=3)
    # the capturable Adam keeps its state on a card; SGD takes both stages
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=0.01)
    step = pp.make_pp_train_step(devs, cfg, n_micro=2, split=3)
    for batch in _pp_batches(2):
        state, m = step(state, batch, torch.Generator(card).manual_seed(1))
        assert all(torch.isfinite(v).all() for v in m.values())
    assert steps.builds == 0 and state.step == 2


@pytest.mark.cuda
def test_world_of_one_sp_and_cp_decode_programs_are_their_eager_bodies(
        card, program_caches):
    """A world of one over NCCL, float32: each rank's SP mask (both ways
    of ``vocal_solo``) and the whole-song CP decode as programs give their
    eager bodies' bits, and the decodes the unsharded ones."""
    import torch.distributed as dist

    from svs_torch.parallel import dryrun
    from svs_torch.parallel import mesh as mesh_lib
    from svs_torch.train import graphs
    from svs_torch.utils.config import SVSConfig

    _, decodes = program_caches
    cfg = SVSConfig(enc_channels=(4, 8, 8, 16, 16, 16))
    mesh = mesh_lib.make_mesh()
    try:
        assert mesh.backend == "nccl" and graphs.mesh_programmed(mesh)
        model = _eval_unet(cfg, card)
        mag = np.abs(np.random.default_rng(3).standard_normal(
            (513, 700))).astype(np.float32)
        sp = dryrun.sp_parity(mesh, model, mag)
        song = np.random.default_rng(1).random((513, 1024), np.float32)
        cp = dryrun.cp_decode_parity(mesh, cfg, song)
    finally:
        dist.destroy_process_group()
    assert sp["programmed"] and sp["vs_eager"] == 0.0, sp
    assert max(sp["segments"], sp["overlap"]) <= dryrun.SP_ATOL, sp
    assert cp["programmed"] and cp["vs_eager"] == 0.0, cp
    assert cp["max_abs_err"] <= dryrun.CP_ATOL, cp
    assert decodes.builds >= 3  # two SP masks and the CP decode


def _eval_unet(cfg, card):
    from svs_torch.models.unet import UNet
    return UNet(cfg, generator=torch.Generator().manual_seed(0)).to(
        card).eval()


# ----------------------------------------------------------- phase clocks
# ``profiling.mark`` inside the captured train step: every replay adds its
# five phases on the card (the eager warm-up adds none), read once by
# ``profiling.snapshot``.  The phases cover each replay from its first
# kernel to its last; CUDA events around the calls cover the replays, the
# batch's copy in and the metrics' copy out (tens of microseconds a step of
# milliseconds): the two agree within 5 %.  A replay that starts long after
# the previous one ends adds no more than its own time: its ``begin`` mark
# stamps the start, so the gap between the two is never counted.

CLOCK_STEPS = 6


@pytest.mark.cuda
def test_phase_marks_of_a_captured_step_add_up_on_the_card(card, step_cache,
                                                          monkeypatch):
    from svs_torch.train import step as tstep
    from svs_torch.utils import profiling
    from svs_torch.utils.config import get_config

    cfg = get_config("default")
    state = tstep.create_train_state(0, cfg, device=card)
    step = tstep.make_train_step(cfg)
    gen = torch.Generator(card).manual_seed(1)
    src = torch.Generator().manual_seed(5)
    batch = {k: torch.rand((16, 512, 128), generator=src).to(card)
             for k in ("mix", "voc", "mix_angle", "voc_angle")}
    names = ("train.unet_fwd", "train.loss_fwd", "train.loss_bwd",
             "train.unet_bwd", "train.optimizer")
    profiling.reset()
    for _ in range(2):  # the eager warm-up, then the capture and a replay
        state, _ = step(state, batch, gen)
    phases = profiling.snapshot()["phases"]["cuda"]
    assert {n: phases[n]["count"] for n in names} == dict.fromkeys(names, 1)
    profiling.reset()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def refuse(*args, **kwargs):
        raise AssertionError("a synchronise during the replays")

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize", refuse)
        m.setattr(torch.cuda.Event, "synchronize", refuse)
        m.setattr(torch.cuda.Stream, "synchronize", refuse)
        start.record()
        for _ in range(CLOCK_STEPS):
            state, _ = step(state, batch, gen)
        end.record()
    phases = profiling.snapshot()["phases"]["cuda"]
    assert {n: phases[n]["count"] for n in names} == dict.fromkeys(
        names, CLOCK_STEPS)
    assert all(phases[n]["s"] > 0 for n in names)
    clocked = sum(phases[n]["s"] for n in names)
    timed = start.elapsed_time(end) / 1e3
    assert abs(clocked - timed) <= 0.05 * timed, (clocked, timed)

    # one replay a quarter second after the last: its phases add its own
    # time, not the gap
    before = profiling.snapshot()["phases"]["cuda"]
    time.sleep(0.25)
    start.record()
    state, _ = step(state, batch, gen)
    end.record()
    after = profiling.snapshot()["phases"]["cuda"]
    added = sum(after[n]["s"] - before[n]["s"] for n in names)
    timed = start.elapsed_time(end) / 1e3
    assert {n: after[n]["count"] - before[n]["count"] for n in names} == \
        dict.fromkeys(names, 1)
    assert 0 < added <= 1.05 * timed, (added, timed)

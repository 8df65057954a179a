"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (a CUDA kernel has no
CPU mode).  They import neither JAX nor svs_tpu, so they run on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances:
- stft_magphase and stft_magnitude, atol 2e-3 / rtol 1e-4:
  tests/test_pallas.py's bound for the TPU kernel against the exact FFT;
  kernel and plain version are both true f32 sums (TF32 off) in different
  orders.  The fft and gemm routes against each other at a power-of-two
  n_fft: 4e-6 of the largest magnitude, tests/test_torch_fft_frontend.py's
  bound between their plain versions (each is within its f32 rounding of
  the exact DFT).
- spectral_mag and loss_partials: both sides multiply the same bf16
  operands exactly and sum in f32 in different orders (the tensor cores'
  accumulators against cuBLAS's f32 GEMM), so magnitudes agree to atol
  2e-3 / rtol 1e-3 and partial sums to rtol 1e-4 (the kernel's log is
  lg2.approx, whose error of ~2^-22 is far inside that); the backward
  rounds the scaled re/im cotangents to bf16 on both sides, where one f32
  ulp of difference moves a value by a bf16 ulp, so gradients are held to
  max|d|/max|g| < 2e-2 and cosine > 0.9999 (tests/test_fused_loss.py's
  bounds between two bf16 paths).
"""

import ctypes

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
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version: true f32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = allow


def _route_counts():
    return cdsp.fft_launches, cdsp.gemm_launches


def _moved(before, n_fft):
    """The route counters after one launch at ``n_fft``: its route's moved
    by one, the other's not at all."""
    fft, gemm = before
    return (fft + 1, gemm) if cdsp.route(n_fft) == "fft" else (fft, gemm + 1)


FRONTEND_SHAPES = [
    (2_097_152, 1024, 768),   # 4-minute song at 8192 Hz, bucket-padded
    (200_000, 1024, 256),     # K = 4
    (9_001, 512, 200),        # ragged frame and bin tiles
    (300_000, 2048, 512),     # fft route, n_fft 2048
    (300_000, 4096, 1024),    # fft route, n_fft 4096
    (100_000, 1000, 250),     # gemm route: no power of two
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
@pytest.mark.parametrize("n_fft,hop", [(1024, 768), (1000, 250)])
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
    (100_000, 1000, 250),     # gemm route
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
    assert mag.shape == want.shape == (n_fft // 2 + 1, 1 + n // hop)
    torch.testing.assert_close(mag, want, atol=ATOL, rtol=RTOL)
    # the magnitude of the magphase kernel is the same sum, the same bits
    assert torch.equal(mag, cdsp.stft_magphase(y, n_fft, hop)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(1024, 768), (1000, 250)])
def test_stft_magnitude_kernel_zero_signal(card, n_fft, hop):
    mag = cdsp.stft_magnitude(torch.zeros(8192, device=card), n_fft, hop)
    torch.cuda.synchronize()
    assert mag.shape == (n_fft // 2 + 1, 1 + 8192 // hop)
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
# under epoch_scan), and the bf16 step is
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
    opt = tstep.make_optimizer(cfg, accum, capturable=True)
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
    # the capture
    per_step = {"matmul_bf16": (0, 0, 0, 0), "pallas_bf16": (6, 3, 0, 0),
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
def test_only_epoch_scan_asks_for_the_capturable_adam(card):
    """The eager loop keeps torch's host-form Adam on the card; the
    capturable form is built on request (``fit`` under ``epoch_scan``)."""
    from svs_torch.train import step as tstep
    from svs_torch.utils.config import get_config
    cfg = get_config("default")
    p = [torch.zeros(4, device=card, requires_grad=True)]
    assert not tstep.make_optimizer(cfg).build(p).param_groups[0][
        "capturable"]
    assert tstep.make_optimizer(cfg, capturable=True).build(p).param_groups[
        0]["capturable"]


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

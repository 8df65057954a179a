"""``mr_mag_impl='matmul_bf16'`` and the loss kernels' rounded instances, on
the CPU.

``matmul_bf16`` is a bf16 DFT matmul whose output is stored as bf16 before
it is squared (``svs_torch/losses/mrstft.py``, ``_spectral_mag_matmul``).
On an sm_90 card it runs as the ``loss_partials`` kernels' rounded
instances; their plain twin (``fused_loss.loss_partials_plain`` and
``loss_partials_bwd_plain`` with ``rounded=True``) is held here against the
PyTorch composition, forward and backward, at the train resolutions and at
the geometries that stress the kernels' tiling
(``tests/test_torch_cuda.py``'s ``TILING_CASES``).  Both round the same
f32 sums of bf16 products to bf16 (in different orders), so values agree
to 1e-3 relative and gradients to max|d|/max|g| < 2e-2 with cosine >
0.9999 (``tests/test_torch_losses.py``'s ``matmul_bf16`` bounds); the
unrounded twin's sums are further from the composition's than the rounded
one's.  The card holds the kernels against the twin
(``tests/test_torch_cuda.py``).

Then the route's rule off the card (the composition, no launch, no
fallback counted), what ``fused_loss.card_takes`` refuses, and the counts
in ``profiling.snapshot()['counters']``.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

from svs_torch.losses import mrstft as tmr
from svs_torch.ops.cuda import fused_loss as cfl
from svs_torch.utils import profiling

# the train resolutions at 3 x 9,001 samples, then the tiling cases
CASES = [
    (3, 9_001, 1024, 120, 600),
    (3, 9_001, 2048, 240, 1200),
    (3, 9_001, 512, 50, 240),
    (2, 9_001, 1024, 120, 598),
    (2, 9_001, 512, 120, 512),
    (1, 20_000, 2048, 240, 1200),
    (2, 1_100, 1024, 120, 600),
    (2, 9_001, 512, 100, 300),
]
G = [[0.7, 0.0, 1.3], [1.0, 2.0, -0.5], [0.0, 0.0, 1.0]]


@pytest.fixture(autouse=True)
def one_thread():
    with threadpoolctl.threadpool_limits(1, user_api="openmp"):
        yield


def _waves(seed, b, t):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((b, t)) * 0.3).astype(
        np.float32)) for _ in range(2)]


def _composed_partials(x, y, n_fft, hop, win):
    """The partial sums from ``_spectral_mag_matmul``'s magnitudes."""
    mx = tmr._spectral_mag_matmul(x, n_fft, hop, win)
    my = tmr._spectral_mag_matmul(y, n_fft, hop, win)
    d = my - mx
    return torch.stack([(d * d).sum((1, 2)), (my * my).sum((1, 2)),
                        torch.abs(torch.log(mx) - torch.log(my)).sum((1, 2))],
                       dim=-1)


def _grad_gap(got, want):
    got, want = got.double(), want.double()
    return (((got - want).abs().max() / want.abs().max()).item(),
            ((got * want).sum() / (got.norm() * want.norm())).item())


@pytest.mark.parametrize("b,t,n_fft,hop,win", CASES)
def test_rounded_plain_twin_is_the_composition(b, t, n_fft, hop, win):
    x, y = _waves(3, b, t)
    g = torch.tensor(G)[:b]
    xg = x.clone().requires_grad_()
    want = _composed_partials(xg, y, n_fft, hop, win)
    (want * g).sum().backward()
    want = want.detach()
    got = cfl.loss_partials_plain(x, y, n_fft, hop, win, rounded=True)
    torch.testing.assert_close(got, want, atol=0, rtol=1e-3)
    dx = cfl.loss_partials_bwd_plain(x, y, g, n_fft, hop, win, rounded=True)
    gap, cos = _grad_gap(dx, xg.grad)
    assert gap < 2e-2 and cos > 0.9999, (gap, cos)
    # the rounding is what makes the twin the composition's function (the
    # gradients' gap is the composition's bf16 overlap-add under autograd)
    plain = cfl.loss_partials_plain(x, y, n_fft, hop, win)
    assert ((got - want).abs() / want.abs()).max() < (
        (plain - want).abs() / want.abs()).max()


@pytest.mark.parametrize("weighted", [False, True])
def test_rounded_stft_loss_fused_is_the_composed_loss(weighted):
    """The fused loss's reductions over the rounded twin's partials give the
    composed ``matmul_bf16`` loss, weighted or not, value and gradient."""
    x, y = _waves(4, 3, 9_000)
    w = torch.tensor([1.0, 0.0, 1.0]) if weighted else None
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = cfl.stft_loss_fused(xa, y, 1024, 120, 600, weight=w, rounded=True)
    want = tmr._composed_loss(xb, y, 1024, 120, 600,
                              tmr._spectral_mag_matmul, 1.0, 1.0, w, None)
    got.backward()
    want.backward()
    torch.testing.assert_close(got, want, atol=0, rtol=1e-3)
    gap, cos = _grad_gap(xa.grad, xb.grad)
    assert gap < 2e-2 and cos > 0.9999, (gap, cos)


def test_rounded_twin_takes_the_compositions_subgradient_at_ties():
    """A perfect prediction: every cell a tie |X| = |Y|.  The composition's
    log term takes ``abs_like_jax``'s +1 there, and so does the rounded
    twin; the unrounded one takes sign(0) = 0 (a zero gradient)."""
    x, _ = _waves(5, 2, 9_000)
    xa, xb, xc = (x.clone().requires_grad_() for _ in range(3))
    cfl.stft_loss_fused(xa, x, 1024, 120, 600, rounded=True).backward()
    tmr._composed_loss(xb, x, 1024, 120, 600, tmr._spectral_mag_matmul,
                       1.0, 1.0, None, None).backward()
    cfl.stft_loss_fused(xc, x, 1024, 120, 600).backward()
    gap, cos = _grad_gap(xa.grad, xb.grad)
    assert gap < 2e-2 and cos > 0.9999, (gap, cos)
    assert (xc.grad == 0).all()


@pytest.mark.parametrize("shape,n_fft,hop,win,dtype", [
    ((2, 9_000), 1024, 120, 600, torch.float32),   # a train geometry
    ((2, 3, 4_000), 512, 50, 240, torch.float32),  # leading dims
    ((2, 9_000), 1024, 120, 600, torch.float64),   # not float32
    ((1, 9_000), 2048, 1301, 1200, torch.float32),  # spans in pieces
])
def test_matmul_bf16_off_the_card_is_the_composition(shape, n_fft, hop, win,
                                                     dtype):
    """On the CPU ``matmul_bf16`` is the composition's bits, whatever the
    kernels would take: nothing launched, no fallback counted."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=gen, dtype=dtype) * 0.3
    y = torch.randn(shape, generator=gen, dtype=dtype) * 0.3
    before = profiling.snapshot()["counters"]
    assert not tmr._kernels_take(x, y, n_fft, hop, win, None)
    got = tmr.stft_loss(x, y, n_fft, hop, win, impl="matmul_bf16")
    want = tmr._composed_loss(x, y, n_fft, hop, win,
                              tmr._spectral_mag_matmul, 1.0, 1.0, None, None)
    assert torch.equal(got, want)
    assert profiling.snapshot()["counters"] == before


def test_card_takes_refuses_what_the_kernels_do_not_run():
    x = torch.zeros((2, 9_000))
    assert not cfl.card_takes(x, x, 1024, 120, 600)  # on the CPU
    meta = torch.zeros((2, 9_000), device="meta")
    assert not cfl.card_takes(meta, meta, 1024, 120, 600)
    assert not cfl.card_takes(x, x[:1], 1024, 120, 600)  # two shapes


def test_loss_counts_are_in_the_snapshot(monkeypatch):
    names = ("fwd_launches", "bwd_launches", "fwd_captured", "bwd_captured")
    for k, name in enumerate(names):
        monkeypatch.setattr(cfl, name, k + 1)
    monkeypatch.setattr(tmr, "matmul_bf16_fallbacks", 7)
    counters = profiling.snapshot()["counters"]
    assert {f"fused_loss.{n}": counters[f"fused_loss.{n}"]
            for n in names} == {f"fused_loss.{n}": k + 1
                                for k, n in enumerate(names)}
    assert counters["mrstft.matmul_bf16_fallbacks"] == 7
    cfl.reset_counts()
    assert all(profiling.snapshot()["counters"][f"fused_loss.{n}"] == 0
               for n in names)

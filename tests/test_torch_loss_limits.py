"""The geometries of the CUDA MR-STFT loss kernels (CPU, geometry and plain
versions only).

svs_tpu's Pallas kernels take any hop and any n_fft: they pad the bins and
the hop to 128 lanes.  The kernels of ``svs_torch/csrc/spectral.cuh`` once
refused an odd hop, an n_fft that is no multiple of 128, and a block's
shared memory past the 232,448 bytes an H100 block may have (the DFT
GEMM's signal spans, one for spectral_mag and two for loss_partials,
growing with the hop; the adjoint's cotangent chunks, growing with the hop
shifts that meet the window).  They now take every one of those
geometries: a 16-bit fragment path for an odd hop, zero basis columns to
whole 128-column tiles, frames staged in pieces a stage where the spans do
not fit, and the shifts in groups where their cotangent rows do not.  Each
case of ``LIMITS`` is the last geometry inside an old limit and the first
one past it: ``spectral.check_card`` accepts both, and the mirror of the
C++ sizes (``dft_staging``, ``adj_group``) shows the staging each takes.
Only more than 65,535 examples and a waveform that is not contiguous are
refused, before any build or launch.  The card tests hold the kernels
against their plain versions at these geometries (tests/test_torch_cuda.py);
here the plain versions are held against the Pallas kernels in interpret
mode.

Tolerances: as tests/test_torch_loss_kernels.py for the magnitudes and
partial sums (atol 5e-5 / rtol 1e-4, rtol 2e-6: the same bf16 roundings, f32
sums in other orders); the gradients as tests/test_fused_loss.py holds two
bf16 paths (max|d|/max|g| < 2e-2, cosine > 0.9999), since at these
geometries a cotangent that one f32 ulp moves across a bf16 rounding
boundary moves by a bf16 ulp (2.6e-3 of the largest gradient observed at
n_fft 1000, hop 125).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svs_torch.ops.cuda import build
from svs_torch.ops.cuda import diff_mag as tdm
from svs_torch.ops.cuda import fused_loss as tfl
from svs_torch.ops.cuda import spectral as sp
from svs_tpu.ops.pallas import diff_mag as jdm
from svs_tpu.ops.pallas import fused_loss as jfl

RESOLUTIONS = [(1024, 120, 600), (2048, 240, 1200), (512, 50, 240)]

# (old limit, nsig, (n_fft, hop, win) inside it, the same past it, what the
# geometry past it takes: spectral.Geometry / mirror attributes)
LIMITS = [
    ("odd hop", 1, (1024, 120, 600), (1024, 121, 600), "odd hop"),
    ("n_fft % 128", 2, (1024, 120, 600), (1026, 120, 600), "zero columns"),
    # (7 + 63*hop + 1216) samples in 64s, two of them: 232,008 bytes at
    # hop 636, 232,520 at hop 638
    ("two signal spans", 2, (2048, 636, 1200), (2048, 638, 1200), "pieces"),
    ("one signal span", 1, (2048, 1296, 1200), (2048, 1298, 1200), "pieces"),
    # 300 shifts meet the window at hop 4, 600 at hop 2
    ("adjoint tiles", 1, (2048, 4, 1200), (2048, 2, 1200), "groups"),
]


def _wave(batch=2, t=5000):
    return torch.zeros((batch, t))


def _staging(geo, nsig):
    """(DFT staging, its bytes, shifts a group, the adjoint's bytes)."""
    how, dft = sp.dft_staging(nsig, geo.hop, geo.n_taps)
    group = sp.adj_group(geo.hop_width, geo.n_shifts)
    return how, dft, group, sp.adj_smem(geo.hop_width, group)


@pytest.mark.parametrize("limit,nsig,inside,past,takes", LIMITS,
                         ids=[case[0] for case in LIMITS])
def test_check_card_refuses_the_first_geometry_past_each_limit(
        limit, nsig, inside, past, takes):
    """No longer refused: check_card takes the last geometry inside each
    old limit and the first past it, and the mirror shows how the kernels
    take the second: the first keeps the span and one group of shifts."""
    x = _wave()
    name = "spectral_mag" if nsig == 1 else "loss_partials"
    geo_in, geo = sp.geometry(x, *inside), sp.geometry(x, *past)
    sp.check_card(x, geo_in, name, nsig)
    sp.check_card(x, geo, name, nsig)
    how_in, dft_in, group_in, adj_in = _staging(geo_in, nsig)
    assert how_in == "span" and group_in == geo_in.n_shifts
    assert dft_in == sp.dft_smem(nsig, sp.dft_span(geo_in.hop,
                                                   geo_in.n_taps))
    how, dft, group, adj = _staging(geo, nsig)
    assert max(dft_in, adj_in, dft, adj) <= sp.SMEM_LIMIT
    if takes == "odd hop":
        assert geo.hop % 2 and how == "span" and group == geo.n_shifts
    elif takes == "zero columns":
        # 513 pairs (bin 0 and Nyquist share pair 0) in 9 tiles of 128
        assert (geo.n_pairs, geo.n_cols) == (513, 1152)
        assert how == "span" and group == geo.n_shifts
    elif takes == "pieces":
        # each ring stage: a 16 KB basis stage and nsig x 64 pieces of 72
        # samples, four stages, the mbarriers and 1 KB of alignment
        assert how == "pieces" and group == geo.n_shifts
        assert dft == 1024 + 4 * (16_384 + nsig * 64 * 72 * 2) + 72
        assert sp.dft_smem(nsig, sp.dft_span(geo.hop, geo.n_taps)) > \
            sp.SMEM_LIMIT
    else:
        # 600 shifts in groups of 389 (tiles 64 wide): 127 + 389 rows of
        # 128 bytes in each of 3 chunk stages
        assert how == "span" and geo.n_shifts == 600
        assert group == 389 and adj == 232_176
        assert sp.adj_smem(geo.hop_width, group + 1) > sp.SMEM_LIMIT


def test_check_card_refuses_more_examples_than_the_grid_takes():
    """The grids' z dimension is the example: at most 65,535 (geometry
    only, no waveform of that many rows is made)."""
    x = _wave()
    geo = sp.geometry(x, *RESOLUTIONS[0])
    for nsig in (1, 2):
        sp.check_card(x, dataclasses.replace(geo, batch=65_535),
                      "loss_partials", nsig)
        with pytest.raises(ValueError, match="at most 65,535 examples"):
            sp.check_card(x, dataclasses.replace(geo, batch=65_536),
                          "loss_partials", nsig)


def test_the_spans_limit_names_its_numbers():
    """Two spans at hop 640 would need 233,032 bytes, past the 232,448 a
    block may have: the frames go in pieces, 140,360 bytes."""
    x = _wave()
    geo = sp.geometry(x, 2048, 640, 1200)
    assert sp.dft_smem(2, sp.dft_span(640, geo.n_taps)) == 233_032
    assert sp.dft_staging(2, 640, geo.n_taps) == ("pieces", 140_360)
    assert sp.dft_staging(1, 640, geo.n_taps)[0] == "span"
    sp.check_card(x, geo, "loss_partials", 2)


@pytest.mark.parametrize("nsig", [1, 2])
@pytest.mark.parametrize("n_fft,hop,win", RESOLUTIONS)
def test_train_resolutions_pass_every_limit(n_fft, hop, win, nsig):
    """The train resolutions keep the design they were timed with: signal
    spans, every shift in one group, no zero columns."""
    x = _wave(32, 97_536)
    geo = sp.geometry(x, n_fft, hop, win)
    sp.check_card(x, geo, "loss_partials" if nsig == 2 else "spectral_mag",
                  nsig)
    how, _, group, _ = _staging(geo, nsig)
    assert how == "span" and group == geo.n_shifts
    assert geo.n_cols == n_fft and geo.hop % 2 == 0


def test_a_strided_waveform_is_refused():
    x = _wave(2, 10_000)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sp.check_card(x, sp.geometry(x, *RESOLUTIONS[0]), "spectral_mag", 1)


class _Built(Exception):
    """What the stand-in for build.load raises: the path got past its
    checks to the build."""


@pytest.mark.parametrize("limit,nsig,inside,past,takes", LIMITS,
                         ids=[case[0] for case in LIMITS])
def test_launch_paths_check_before_building_or_launching(
        limit, nsig, inside, past, takes, monkeypatch):
    """Each kernel wrapper's launch path, forward and backward, takes the
    geometry past each old limit through check_card to the build (here a
    stand-in that raises), with nothing allocated past the check or
    counted; a batch past the grids' limit still stops at the check."""
    def built(name):
        raise _Built(name)

    monkeypatch.setattr(build, "load", built)
    x = _wave()
    geo = sp.geometry(x, *past)
    if nsig == 1:
        counts = lambda: (tdm.fwd_launches, tdm.bwd_launches)  # noqa: E731
        g = torch.zeros((2, geo.n_bins, geo.n_frames))
        calls = [lambda geo: tdm._launch_fwd(x, geo),
                 lambda geo: tdm._launch_bwd(x, g, geo)]
    else:
        counts = lambda: (tfl.fwd_launches, tfl.bwd_launches)  # noqa: E731
        calls = [lambda geo: tfl._launch_fwd(x, x, geo),
                 lambda geo: tfl._launch_bwd(x, x, torch.ones((2, 3)), geo)]
    before = counts()
    for call in calls:
        with pytest.raises(_Built):
            call(geo)
        with pytest.raises(ValueError, match="at most 65,535 examples"):
            call(dataclasses.replace(geo, batch=65_536))
    assert counts() == before


# the widened geometries, (n_fft, hop, win, samples): DDSP's smallest
# scale (64 columns padded to 128); an odd hop with n_fft % 128 != 0;
# spans past the limit (pieces); an odd n_fft (no Nyquist bin: 65 pairs,
# 130 columns padded to 256) at an odd hop.  The short hops whose shifts
# the adjoint takes in groups are not here: the plain versions treat every
# hop alike, and the Pallas kernels in interpret mode take minutes at them
# (over 5 at hop 2, n_fft 2048; 50 s at hop 8, n_fft 512); the card test
# holds the kernels against the plain versions at hop 2, n_fft 2048
WIDENED = [(64, 16, 64, 4_000), (1000, 125, 600, 6_000),
           (1024, 700, 1024, 9_000), (129, 33, 100, 3_000)]


@pytest.fixture
def interpret_mode():
    jdm._INTERPRET = jfl._INTERPRET = True
    yield
    jdm._INTERPRET = jfl._INTERPRET = False


def _np_wave(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3
            ).astype(np.float32)


def _close_grads(got, want):
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2
    cos = float((got * want).sum() / (np.linalg.norm(got)
                                      * np.linalg.norm(want)))
    assert cos > 0.9999


@pytest.mark.parametrize("n_fft,hop,win,t", WIDENED,
                         ids=[f"{g[0]}-{g[1]}-{g[2]}" for g in WIDENED])
def test_plain_versions_match_pallas_past_the_old_limits(
        n_fft, hop, win, t, interpret_mode):
    """spectral_mag and loss_partials, forward and backward: the plain
    versions the CUDA kernels are held against, on the CPU, against the
    Pallas kernels in interpret mode on the same waveforms."""
    x, y = _np_wave(0, (2, t)), _np_wave(1, (2, t))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    geo = sp.Geometry(2, t, n_fft, hop, win)
    w = _np_wave(2, (2, geo.n_bins, geo.n_frames))

    want = np.asarray(jdm.spectral_mag(jx, n_fft, hop, win))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        jnp.log(jdm.spectral_mag(v, n_fft, hop, win)) * w))(jx))
    xt = torch.from_numpy(x).requires_grad_()
    got = tdm.spectral_mag(xt, n_fft, hop, win)
    assert got.shape == want.shape == (2, geo.n_bins, geo.n_frames)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-5,
                               rtol=1e-4)
    (torch.log(got) * torch.from_numpy(w)).sum().backward()
    _close_grads(xt.grad.numpy(), want_g)

    want = np.asarray(jfl.loss_partials(jx, jy, n_fft, hop, win, False))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jfl.loss_partials(
        v, jy, n_fft, hop, win, False)[:, (0, 2)]))(jx))
    xt = torch.from_numpy(x).requires_grad_()
    got = tfl.loss_partials(xt, torch.from_numpy(y), n_fft, hop, win)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-6)
    got[:, [0, 2]].sum().backward()
    _close_grads(xt.grad.numpy(), want_g)

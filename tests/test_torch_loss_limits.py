"""The limits of the CUDA MR-STFT loss kernels, checked before any launch
(CPU, geometry only).

The kernels of ``svs_torch/csrc/spectral.cuh`` take fewer geometries than
svs_tpu's Pallas kernels: an even hop, n_fft a multiple of 128, at most
65,535 examples, and a block's shared memory within the 232,448 bytes an
H100 block may have: the DFT GEMM's signal spans (one for spectral_mag,
two for loss_partials) grow with the hop, the adjoint's cotangent chunks
with the hop shifts that meet the window.  ``spectral.check_card`` refuses
a geometry past any of them with a ``ValueError`` that names the limit,
from a mirror of the C++ sizes; the card tests hold that mirror against
the C++ formulas (tests/test_torch_cuda.py).  Each case here is the first
geometry past its limit and the last one inside it.
"""

import dataclasses

import pytest
import torch

from svs_torch.ops.cuda import diff_mag as tdm
from svs_torch.ops.cuda import fused_loss as tfl
from svs_torch.ops.cuda import spectral as sp

RESOLUTIONS = [(1024, 120, 600), (2048, 240, 1200), (512, 50, 240)]

# (limit, nsig, (n_fft, hop, win) inside, the same past it, message)
LIMITS = [
    ("odd hop", 1, (1024, 120, 600), (1024, 121, 600), "even hop"),
    ("n_fft % 128", 2, (1024, 120, 600), (1026, 120, 600),
     r"n_fft % 128 == 0"),
    # (7 + 63*hop + 1216) samples in 64s, two of them: 232,008 bytes at
    # hop 636, 232,520 at hop 638
    ("two signal spans", 2, (2048, 636, 1200), (2048, 638, 1200),
     "two signal spans of 63\\*hop \\+ n_taps samples need 232,520 bytes"),
    ("one signal span", 1, (2048, 1296, 1200), (2048, 1298, 1200),
     "one signal span of 63\\*hop \\+ n_taps samples need 232,648 bytes"),
    # 300 shifts meet the window at hop 4, 600 at hop 2
    ("adjoint tiles", 1, (2048, 4, 1200), (2048, 2, 1200),
     "the adjoint's 600 hop shifts that meet the window need 313,200 bytes"),
]


def _wave(batch=2, t=5000):
    return torch.zeros((batch, t))


@pytest.mark.parametrize("limit,nsig,inside,past,message", LIMITS,
                         ids=[case[0] for case in LIMITS])
def test_check_card_refuses_the_first_geometry_past_each_limit(
        limit, nsig, inside, past, message):
    x = _wave()
    name = "spectral_mag" if nsig == 1 else "loss_partials"
    sp.check_card(x, sp.geometry(x, *inside), name, nsig)
    with pytest.raises(ValueError, match=f"^{name}: .*{message}") as err:
        sp.check_card(x, sp.geometry(x, *past), name, nsig)
    assert str(err.value).endswith(f"(hop {past[1]}, n_fft {past[0]}, "
                                   f"win {past[2]})")


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
    x = _wave()
    with pytest.raises(ValueError) as err:
        sp.check_card(x, sp.geometry(x, 2048, 640, 1200), "loss_partials", 2)
    assert str(err.value) == (
        "loss_partials: two signal spans of 63*hop + n_taps samples need "
        "233,032 bytes of shared memory a block, more than the 232,448 an "
        "H100 block may have (hop 640, n_fft 2048, win 1200)")


@pytest.mark.parametrize("nsig", [1, 2])
@pytest.mark.parametrize("n_fft,hop,win", RESOLUTIONS)
def test_train_resolutions_pass_every_limit(n_fft, hop, win, nsig):
    x = _wave(32, 97_536)
    sp.check_card(x, sp.geometry(x, n_fft, hop, win),
                  "loss_partials" if nsig == 2 else "spectral_mag", nsig)


def test_a_strided_waveform_is_refused():
    x = _wave(2, 10_000)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sp.check_card(x, sp.geometry(x, *RESOLUTIONS[0]), "spectral_mag", 1)


@pytest.mark.parametrize("limit,nsig,inside,past,message", LIMITS,
                         ids=[case[0] for case in LIMITS])
def test_launch_paths_check_before_building_or_launching(
        limit, nsig, inside, past, message):
    """Each kernel wrapper's launch path, forward and backward, raises the
    limit's ``ValueError`` first: before the kernels are built (no nvcc
    here, which would raise ``RuntimeError``), allocated or counted."""
    x = _wave()
    geo = sp.geometry(x, *past)
    if nsig == 1:
        counts = lambda: (tdm.fwd_launches, tdm.bwd_launches)  # noqa: E731
        g = torch.zeros((2, geo.n_bins, geo.n_frames))
        calls = [lambda: tdm._launch_fwd(x, geo),
                 lambda: tdm._launch_bwd(x, g, geo)]
    else:
        counts = lambda: (tfl.fwd_launches, tfl.bwd_launches)  # noqa: E731
        calls = [lambda: tfl._launch_fwd(x, x, geo),
                 lambda: tfl._launch_bwd(x, x, torch.ones((2, 3)), geo)]
    before = counts()
    for call in calls:
        with pytest.raises(ValueError, match=message):
            call()
    assert counts() == before

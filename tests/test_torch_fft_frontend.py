"""The fft route of the port's STFT front end (svs_torch/ops/cuda/dsp.py,
kernel svs_torch/csrc/stft_fft.cu) on the CPU.

Its plain versions (the kernel's packing, Stockham passes, split step and
epilogue in f32 tensor ops, from the kernel's own f32 tables) are what the
wrappers take for a CPU tensor at a power-of-two n_fft, so
tests/test_torch_dsp_kernel.py holds them against svs_tpu's Pallas kernels
in interpret mode (K = 2, 3, 4 and n_fft 2048); the mixed route, every
other n_fft up to 16384, is tests/test_torch_mixed_frontend.py's. Here: the
gemm route (the earlier design, and the route of an even n_fft above 16384)
against Pallas at an n_fft that is no power of two (atol 2e-3 / rtol 1e-4,
tests/test_pallas.py's bound for the TPU kernel against the exact FFT), and
the fft plain version against the gemm one, to 4e-6 of the largest
magnitude: both are f32 evaluations of the same windowed sums, each within
its rounding of the exact DFT (the FFT's grows with log2 n_fft, the GEMM's
sums with n_fft), which keeps their difference several times inside the
bound at n_fft 64-4096.

The kernel itself is held against these plain versions on the card by
tests/test_torch_cuda.py and ``python3 chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svs_torch.ops.cuda import dsp as cdsp
from svs_tpu.ops.pallas import dsp as pdsp

ATOL, RTOL = 2e-3, 1e-4
ROUTE_RTOL = 4e-6

SHAPES = [
    (24_576, 1024, 768),   # K = 2, the default preset
    (12_000, 1024, 256),   # K = 4, the hq44k geometry
    (9_001, 512, 200),     # K = 3, a length that is no multiple of hop
    (20_000, 2048, 512),   # K = 4, n_fft 2048 (a radix-2 last pass)
]


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.3).astype(np.float32)


def test_gemm_route_at_a_non_power_of_two_matches_pallas():
    """The gemm design, which the mixed route replaced at n_fft 1000 and
    which stays reachable through ``launch(..., via="gemm")``."""
    y = _signal(20_000, seed=2)
    want_mag, want_ri = (np.asarray(a) for a in pdsp.stft_magphase(
        jnp.asarray(y), 1000, 250, interpret=True))
    mag, ri = cdsp.stft_magphase_plain(torch.from_numpy(y), 1000, 250)
    np.testing.assert_allclose(mag.numpy(), want_mag, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(mag.numpy() * ri.numpy(), want_mag * want_ri,
                               atol=ATOL)


@pytest.mark.parametrize("n,n_fft,hop", SHAPES + [
    (300_000, 4096, 1024), (5_000, 64, 16), (7_000, 128, 50),
    (9_000, 256, 100), (3_000, 64, 100)])   # hop > n_fft
def test_fft_plain_matches_gemm_plain(n, n_fft, hop):
    y = torch.from_numpy(_signal(n, seed=3))
    mag, ri = cdsp.stft_magphase_fft_plain(y, n_fft, hop)
    ref_mag, ref_ri = cdsp.stft_magphase_plain(y, n_fft, hop)
    bound = ROUTE_RTOL * ref_mag.abs().max().item()
    torch.testing.assert_close(mag, ref_mag, atol=bound, rtol=0)
    torch.testing.assert_close(mag * ri, ref_mag * ref_ri, atol=bound, rtol=0)
    # the magnitude-only plain version is the same arithmetic
    assert torch.equal(cdsp.stft_magnitude_fft_plain(y, n_fft, hop), mag)


@pytest.mark.parametrize("n_fft,hop", [(1024, 768), (64, 16), (4096, 1024)])
def test_fft_plain_zero_signal_is_exact(n_fft, hop):
    y = torch.zeros(8192)
    mag, ri = cdsp.stft_magphase_fft_plain(y, n_fft, hop)
    assert bool((mag == 0).all())
    assert bool((ri[0] == 1).all()) and bool((ri[1] == 0).all())
    assert bool((cdsp.stft_magnitude_fft_plain(y, n_fft, hop) == 0).all())


@pytest.mark.parametrize("n_fft", [64, 1024, 4096])
def test_fft_tables_are_float64_rounded_to_f32(n_fft):
    window, tw = cdsp.fft_tables(n_fft)
    assert window.dtype == tw.dtype == np.float32
    assert window.shape == (n_fft,) and tw.shape == (n_fft, 2)
    k = np.arange(n_fft, dtype=np.float64)
    want = np.exp(-2j * np.pi * k / n_fft)
    np.testing.assert_array_equal(tw[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], want.imag.astype(np.float32))
    np.testing.assert_array_equal(
        window, (0.5 - 0.5 * np.cos(2 * np.pi * k / n_fft)).astype(np.float32))
    # the window is the gemm basis's and the Pallas kernel's
    np.testing.assert_array_equal(cdsp.windowed_dft(n_fft)[0][:, 0], window)


def test_fft_passes():
    assert cdsp.fft_passes(512) == [(8, 1), (8, 8), (8, 64)]
    assert cdsp.fft_passes(1024) == [(8, 1), (8, 8), (8, 64), (2, 512)]
    assert cdsp.fft_passes(2048) == [(8, 1), (8, 8), (8, 64), (4, 512)]
    assert cdsp.fft_passes(32) == [(8, 1), (4, 8)]


def test_route_is_chosen_by_n_fft():
    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        assert cdsp.route(n_fft) == "fft"
    # every other n_fft up to 16384, odd ones included
    for n_fft in (1000, 1536, 32, 8192, 2, 1023, 999, 3, 16384, 16383):
        assert cdsp.route(n_fft) == "mixed"
    # above it, an even n_fft keeps the gemm route and an odd one is refused
    for n_fft in (16386, 20000):
        assert cdsp.route(n_fft) == "gemm"
    with pytest.raises(ValueError, match="odd n_fft=16385 above 16384"):
        cdsp.route(16385)
    for n_fft in (1, 0, -4):
        with pytest.raises(ValueError, match="at least 2"):
            cdsp.route(n_fft)
    with pytest.raises(ValueError, match="power-of-two"):
        cdsp.stft_magphase_fft_plain(torch.zeros(4096), 1000, 250)


def test_cpu_wrappers_take_their_routes_plain_version():
    y = torch.from_numpy(_signal(9_000, seed=4))
    for n_fft, hop, fft in ((1024, 768, True), (1000, 250, False)):
        mag, ri = cdsp.stft_magphase(y, n_fft, hop)
        want = (cdsp.stft_magphase_fft_plain if fft
                else cdsp.stft_magphase_mixed_plain)(y, n_fft, hop)
        assert torch.equal(mag, want[0]) and torch.equal(ri, want[1])
        # dense on the CPU (the card's fft and mixed routes return
        # padded-row views)
        assert mag.is_contiguous() and ri.is_contiguous()
        assert cdsp.stft_magnitude(y, n_fft, hop).is_contiguous()
        assert cdsp.plain_for(n_fft, False) is (
            cdsp.stft_magnitude_fft_plain if fft
            else cdsp.stft_magnitude_mixed_plain)
        assert torch.equal(cdsp.stft_magnitude(y, n_fft, hop), mag)


def test_cpu_tensor_moves_no_launch_counter():
    counters = ("launches", "mag_launches", "fft_launches",
                "mixed_launches", "gemm_launches")
    before = [getattr(cdsp, c) for c in counters]
    for n_fft, hop in ((1024, 768), (1000, 250), (20_000, 5000)):
        cdsp.stft_magphase(torch.zeros(4096), n_fft, hop)
        cdsp.stft_magnitude(torch.zeros(4096), n_fft, hop)
    assert [getattr(cdsp, c) for c in counters] == before


def test_cpu_f32_sqrt_is_within_one_ulp_of_the_rounded_root():
    """The plain versions take the root in float64 and round once, the
    kernels' correctly rounded ``sqrtf``; PyTorch's f32 ``sqrt`` may differ
    from that by one ulp, never more, and the same call gives the same
    bits."""
    rng = np.random.default_rng(5)
    re, im = (torch.from_numpy((rng.standard_normal(1 << 20) * 7).astype(
        np.float32)) for _ in range(2))
    power = re * re + im * im
    want = cdsp._magnitude(re, im)
    # numpy's f32 sqrt is the hardware's, correctly rounded
    np.testing.assert_array_equal(want.numpy(), np.sqrt(power.numpy()))
    got = torch.sqrt(power)
    ulps = (got.view(torch.int32) - want.view(torch.int32)).abs()
    assert ulps.max().item() <= 1
    for _ in range(5):
        assert torch.equal(torch.sqrt(power), got)


def test_plain_versions_repeat_bit_for_bit_at_the_decode_shape():
    """A seeded stress test: each route's plain version on a 4-minute song,
    called again and again in one process, gives the same bits, and the two
    routes agree to ROUTE_RTOL over all 2,731 frames.  A plain version once
    gave a value wrong in its fourth digit at random, with no cause found
    (ROADMAP.md C); this is where it would show again."""
    y = torch.from_numpy(_signal(2_097_152, seed=6))
    first = {f: f(y, 1024, 768) for f in (cdsp.stft_magphase_fft_plain,
                                          cdsp.stft_magphase_plain)}
    for _ in range(4):
        for f, (mag, ri) in first.items():
            again = f(y, 1024, 768)
            assert torch.equal(again[0], mag) and torch.equal(again[1], ri)
    (mag, _), (ref, _) = first.values()
    torch.testing.assert_close(mag, ref, rtol=0,
                               atol=ROUTE_RTOL * ref.abs().max().item())


def test_launch_refuses_a_cpu_tensor_and_an_unknown_route():
    for via, n_fft in (("fft", 1024), ("mixed", 1000), ("gemm", 1024)):
        with pytest.raises(ValueError, match="CUDA"):
            cdsp.launch(torch.zeros(4096), n_fft, 768, True, via)
    with pytest.raises(ValueError, match="route"):
        cdsp.launch(torch.zeros(4096), 1024, 768, True, "dft")
    with pytest.raises(ValueError, match="power-of-two"):
        cdsp.launch(torch.zeros(4096), 1000, 250, False, "fft")

"""The mixed route of the port's STFT front end (svs_torch/ops/cuda/dsp.py,
kernel svs_torch/csrc/stft_mixed.cu) on the CPU: every n_fft in [2, 16384]
that the fft route does not take, odd ones included.

Its plain versions (the kernel's packing, pass plan, Bluestein steps, split
step and epilogue in f32 tensor ops, from the kernel's own f32 tables) are
what the wrappers take for a CPU tensor at those n_fft.  Tolerances:

- against svs_tpu's Pallas kernels in interpret mode, atol 2e-3 / rtol
  1e-4: tests/test_pallas.py's bound for the TPU kernel against the exact
  FFT (both sides are f32 evaluations of the same windowed sums);
- against the gemm route's plain version (even n_fft) and against a
  float64 DFT, ROUTE_RTOL = 4e-6 of the largest magnitude, the bound
  tests/test_torch_fft_frontend.py holds the fft route to.  Bluestein's
  f32 chirp, filter and two transforms stay within it too: at n_fft 1018,
  9998 and 16382 they measured 4e-7 to 8e-7 of the largest magnitude,
  as the 7-smooth plans do.

The kernel itself is held against these plain versions on the card by
tests/test_torch_cuda.py and ``python3 chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svs_torch.data import prep as tprep
from svs_torch.ops.cuda import dsp as cdsp
from svs_tpu.data import prep as jprep
from svs_tpu.ops.pallas import dsp as pdsp

ATOL, RTOL = 2e-3, 1e-4
ROUTE_RTOL = 4e-6

PALLAS_SHAPES = [
    (1000, 250),   # P = 500 = 4 * 5^3
    (999, 256),    # odd, Bluestein: 999 = 3^3 * 37, L = 2048
    (441, 110),    # odd, 7-smooth: 3^2 * 7^2
    (1018, 256),   # even, Bluestein: P = 509 (prime), L = 1024
]


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.3).astype(np.float32)


def _dft64(y, n_fft, hop):
    """The centred periodic-hann rfft of ``y`` in float64, (n_bins,
    n_frames)."""
    yp = np.pad(y.astype(np.float64), (n_fft // 2, n_fft // 2))
    n_frames = 1 + (len(yp) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    return np.fft.rfft(yp[idx] * w, axis=1).T


@pytest.mark.parametrize("n_fft,hop", PALLAS_SHAPES)
def test_mixed_plain_matches_pallas(n_fft, hop):
    y = _signal(20_000, seed=n_fft)
    assert cdsp.route(n_fft) == "mixed"
    want_mag, want_ri = (np.asarray(a) for a in pdsp.stft_magphase(
        jnp.asarray(y), n_fft, hop, interpret=True))
    mag, ri = cdsp.stft_magphase(torch.from_numpy(y), n_fft, hop)
    mag, ri = mag.numpy(), ri.numpy()
    assert mag.shape == want_mag.shape and ri.shape == want_ri.shape
    np.testing.assert_allclose(mag, want_mag, atol=ATOL, rtol=RTOL)
    # phase is ill-conditioned at small |S|: compare the complex spectrum
    np.testing.assert_allclose(mag * ri, want_mag * want_ri, atol=ATOL)
    np.testing.assert_allclose(np.hypot(ri[0], ri[1]), 1.0, atol=1e-5)


@pytest.mark.parametrize("n_fft,hop", PALLAS_SHAPES)
def test_mixed_magnitude_plain_matches_pallas(n_fft, hop):
    y = _signal(20_000, seed=n_fft + 1)
    want = np.asarray(pdsp.stft_magnitude(jnp.asarray(y), n_fft, hop,
                                          interpret=True))
    got = cdsp.stft_magnitude(torch.from_numpy(y), n_fft, hop).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_fft,hop", [
    (1000, 250), (1018, 256), (1536, 384), (2000, 500), (32, 8), (4, 2),
    (3000, 5000)])   # the last: hop > n_fft
def test_mixed_plain_matches_gemm_plain(n_fft, hop):
    y = torch.from_numpy(_signal(40_000, seed=3))
    mag, ri = cdsp.stft_magphase_mixed_plain(y, n_fft, hop)
    ref_mag, ref_ri = cdsp.stft_magphase_plain(y, n_fft, hop)
    bound = ROUTE_RTOL * ref_mag.abs().max().item()
    torch.testing.assert_close(mag, ref_mag, atol=bound, rtol=0)
    torch.testing.assert_close(mag * ri, ref_mag * ref_ri, atol=bound, rtol=0)
    # the magnitude-only plain version is the same arithmetic
    assert torch.equal(cdsp.stft_magnitude_mixed_plain(y, n_fft, hop), mag)


@pytest.mark.parametrize("n_fft,hop", [
    (2, 1), (3, 1), (5, 3), (11, 4), (97, 30), (441, 110), (999, 256),
    (1764, 441), (2205, 512), (8192, 2048), (16382, 4096), (8193, 4096),
    (15625, 16000)])
def test_mixed_plain_matches_a_float64_dft(n_fft, hop):
    """Odd n_fft (two frames a sequence, 7-smooth or Bluestein), tiny ones,
    and the largest plans: a power of two above the fft route's, the
    largest L of an even n_fft (16382), Bluestein's L = 32,768 (8193) and
    an odd 7-smooth n_fft at a hop past it (15625)."""
    y = _signal(max(20_000, 3 * n_fft), seed=4)
    want = _dft64(y, n_fft, hop)
    mag, ri = cdsp.stft_magphase_mixed_plain(torch.from_numpy(y), n_fft, hop)
    got = mag.double().numpy() * (ri[0].double().numpy()
                                  + 1j * ri[1].double().numpy())
    assert got.shape == want.shape == (n_fft // 2 + 1, want.shape[1])
    assert np.abs(got - want).max() <= ROUTE_RTOL * np.abs(want).max()


@pytest.mark.parametrize("n_frames", [7, 8])
def test_odd_n_fft_pairs_frames_and_an_odd_count_with_zeros(n_frames):
    """At an odd n_fft frames 2s and 2s+1 share a sequence; the last of an
    odd count is paired with zeros.  Either count gives every frame."""
    hop, n_fft = 100, 201
    y = _signal((n_frames - 1) * hop + 1, seed=5)
    mag, _ = cdsp.stft_magphase_mixed_plain(torch.from_numpy(y), n_fft, hop)
    want = np.abs(_dft64(y, n_fft, hop))
    assert mag.shape == want.shape == (101, n_frames)
    assert np.abs(mag.numpy() - want).max() <= ROUTE_RTOL * want.max()


@pytest.mark.parametrize("n_fft,hop", [(1000, 250), (999, 256), (441, 110),
                                       (1018, 256), (8193, 4096)])
def test_mixed_plain_zero_signal_is_exact(n_fft, hop):
    y = torch.zeros(20_000)
    mag, ri = cdsp.stft_magphase_mixed_plain(y, n_fft, hop)
    assert bool((mag == 0).all())
    assert bool((ri[0] == 1).all()) and bool((ri[1] == 0).all())
    assert bool((cdsp.stft_magnitude_mixed_plain(y, n_fft, hop) == 0).all())


def test_mixed_passes():
    assert cdsp.mixed_passes(500) == [(4, 1), (5, 4), (5, 20), (5, 100)]
    assert cdsp.mixed_passes(441) == [(3, 1), (3, 3), (7, 9), (7, 63)]
    assert cdsp.mixed_passes(768) == [(8, 1), (8, 8), (4, 64), (3, 256)]
    assert cdsp.mixed_passes(2048) == cdsp.fft_passes(2048)
    assert cdsp.mixed_passes(1) == []
    for q in (509, 11, 2 * 13, 999):
        with pytest.raises(ValueError, match="prime factor above 7"):
            cdsp.mixed_passes(q)


@pytest.mark.parametrize("n_fft,p,q", [
    (1000, 500, 500), (1536, 768, 768), (441, 441, 441), (8192, 4096, 4096),
    (2, 1, 1), (3, 3, 3), (32, 16, 16),
    (999, 999, 2048),       # 2p - 1 = 1997
    (1018, 509, 1024),      # 2p - 1 = 1017
    (11, 11, 32),
    (16382, 8191, 16384),   # the largest L an even n_fft needs
    (8193, 8193, 32768),    # odd above 8192: L = 32,768, planes in scratch
])
def test_mixed_plan_picks_bluestein_l(n_fft, p, q):
    plan = cdsp.mixed_plan(n_fft)
    assert (plan.p, plan.q) == (p, q)
    assert plan.bluestein == (q != p)
    assert plan.frames_per_seq == (2 if n_fft % 2 else 1)
    assert int(np.prod([r for r, _ in plan.passes])) == q
    if plan.bluestein:
        assert q & (q - 1) == 0 and q >= 2 * p - 1 and q // 2 < 2 * p - 1


def test_mixed_route_limits():
    for n_fft in (1000, 999, 1, 16384, 16383, 2, 3, 32, 8192):
        if n_fft < 2:
            with pytest.raises(ValueError, match="at least 2"):
                cdsp.mixed_plan(n_fft)
        else:
            assert cdsp.mixed_plan(n_fft).n_fft == n_fft
    for n_fft in (1024, 64, 4096, 16386, 20000):
        with pytest.raises(ValueError, match="mixed route takes"):
            cdsp.mixed_plan(n_fft)
    with pytest.raises(ValueError, match="above 16384"):
        cdsp.mixed_plan(16385)


@pytest.mark.parametrize("q", [500, 441, 2048, 768, 1, 32768])
def test_dit_order_and_the_passes_are_the_dft(q):
    """The plain passes in float64 with a float64 twiddle table: points
    packed at ``dit_order`` and the DIT passes give numpy's FFT in natural
    order, and the mirrored DIF passes leave bin k at ``dit_order[k]``.
    The butterflies' constants are the kernel's f32 ones, so the sums agree
    to ~1e-7 of the largest value (1e-6 allowed); a point out of place
    would be off by its own size."""
    passes = cdsp.mixed_passes(q)
    perm = cdsp.dit_order(q, passes)
    assert perm.dtype == np.int32
    assert np.array_equal(np.sort(perm), np.arange(q))
    rng = np.random.default_rng(q)
    z = rng.standard_normal((2, q)) + 1j * rng.standard_normal((2, q))
    want = np.fft.fft(z, axis=1)
    ang = 2 * np.pi * np.arange(q) / q
    tw = torch.from_numpy(np.stack([np.cos(ang), -np.sin(ang)], 1))
    pr, pi = torch.zeros(2, q, dtype=torch.float64), torch.zeros(
        2, q, dtype=torch.float64)
    pr[:, perm.astype(np.int64)] = torch.from_numpy(z.real)
    pi[:, perm.astype(np.int64)] = torch.from_numpy(z.imag)
    re, im = cdsp._run_passes(pr, pi, passes, tw, dit=True)
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), want,
                               atol=1e-6 * np.abs(want).max())
    re, im = cdsp._run_passes(torch.from_numpy(z.real),
                              torch.from_numpy(z.imag), passes, tw, dit=False)
    got = (re.numpy() + 1j * im.numpy())[:, perm]
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


def test_bit_reversal_is_the_radix_2_dit_order():
    q = 64
    passes = [(2, 1 << i) for i in range(6)]
    rev = [int(f"{n:06b}"[::-1], 2) for n in range(q)]
    assert cdsp.dit_order(q, passes).tolist() == rev


@pytest.mark.parametrize("n_fft", [1000, 999, 1018, 441, 2])
def test_mixed_tables_are_float64_rounded_to_f32(n_fft):
    plan = cdsp.mixed_plan(n_fft)
    t = cdsp.mixed_tables(n_fft)
    p, q = plan.p, plan.q
    assert all(v.dtype == np.float32 for k, v in t.items() if k != "perm")
    k = np.arange(q, dtype=np.float64)
    tw = np.exp(-2j * np.pi * k / q)
    np.testing.assert_array_equal(t["tw"][:, 0], tw.real.astype(np.float32))
    np.testing.assert_array_equal(t["tw"][:, 1], tw.imag.astype(np.float32))
    np.testing.assert_array_equal(t["window"], cdsp.hann(n_fft))
    np.testing.assert_array_equal(t["perm"], cdsp.dit_order(q, plan.passes))
    if n_fft % 2 == 0:
        sp = np.exp(-2j * np.pi * np.arange(p) / n_fft)
        np.testing.assert_array_equal(t["split"][:, 1],
                                      sp.imag.astype(np.float32))
        assert t["split"].shape == (p, 2)
    else:
        assert t["split"].shape == (0, 2)
    if not plan.bluestein:
        assert t["chirp"].shape == t["filt"].shape == (0, 2)
        return
    # the chirp's n^2 is reduced mod 2p in integers: exact at any n
    n = np.arange(p)
    chirp = np.exp(-1j * np.pi * ((n.astype(np.int64) ** 2) % (2 * p)) / p)
    np.testing.assert_array_equal(t["chirp"][:, 0],
                                  chirp.real.astype(np.float32))
    np.testing.assert_allclose(t["chirp"][:, 0] + 1j * t["chirp"][:, 1],
                               np.exp(-1j * np.pi * n.astype(np.float64) ** 2
                                      / p), atol=1e-6)
    # the filter: the FFT of the circular conj(chirp) over q, perm's order
    b = np.zeros(q, np.complex128)
    b[:p] = np.conj(chirp)
    b[q - p + 1:] = np.conj(chirp[1:])[::-1]
    filt = np.fft.fft(b)[np.argsort(t["perm"])] / q
    got = t["filt"][:, 0] + 1j * t["filt"][:, 1]
    np.testing.assert_allclose(got, filt, atol=1e-7)


@pytest.mark.parametrize("n_fft,hop", [
    (1000, 250), (999, 256), (441, 110), (1018, 256), (1536, 384),
    (8192, 2048), (2, 1), (11, 4), (2205, 512), (16382, 4096),
    (8193, 4096), (16383, 4096), (15625, 4000), (15625, 16000)])
def test_mixed_geometry_fits_a_block(n_fft, hop):
    plan = cdsp.mixed_plan(n_fft)
    geo = cdsp.mixed_geometry(plan, hop)
    assert geo.threads % 32 == 0 and geo.seqs * geo.threads <= 1024
    assert 0 < geo.smem <= cdsp._SMEM_MAX
    planes = 8 * geo.seqs * cdsp.seq_pairs(plan.q)
    span = 4 * ((geo.seqs * plan.frames_per_seq - 1) * min(hop, n_fft)
                + n_fft)
    # only Bluestein's L = 32,768 keeps its planes in device memory
    assert geo.scratch == (plan.q == 32768)
    assert geo.staged == ((0 if geo.scratch else planes) + span
                          <= cdsp._SMEM_MAX)
    assert geo.smem == (0 if geo.scratch else planes) + (
        span if geo.staged else 0)
    # an odd 7-smooth n_fft above ~12,000 at a hop past n_fft packs from
    # the signal itself
    assert geo.staged or (n_fft, hop) == (15625, 16000)


def test_cpu_wrappers_take_the_mixed_plain_version():
    y = torch.from_numpy(_signal(9_000, seed=6))
    counters = ("launches", "mag_launches", "fft_launches",
                "mixed_launches", "gemm_launches")
    before = [getattr(cdsp, c) for c in counters]
    for n_fft, hop in ((999, 256), (1000, 250), (441, 110)):
        assert cdsp.plain_for(n_fft, True) is cdsp.stft_magphase_mixed_plain
        assert cdsp.plain_for(n_fft, False) is (
            cdsp.stft_magnitude_mixed_plain)
        mag, ri = cdsp.stft_magphase(y, n_fft, hop)
        want = cdsp.stft_magphase_mixed_plain(y, n_fft, hop)
        assert torch.equal(mag, want[0]) and torch.equal(ri, want[1])
        assert mag.is_contiguous() and ri.is_contiguous()
        assert torch.equal(cdsp.stft_magnitude(y, n_fft, hop), mag)
    assert [getattr(cdsp, c) for c in counters] == before


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prep_stft_magphase_at_an_odd_win_size_matches_svs_tpu(impl):
    """``data_cli --win_size 999``'s front end: svs_torch's kernel path
    (its plain version on the CPU) against svs_tpu's on the CPU."""
    y = _signal(20_000, seed=7)
    want_mag, want_phase = jprep.stft_magphase(y, 999, 256, impl=impl)
    mag, phase = tprep.stft_magphase(y, 999, 256, impl="kernel", device="cpu")
    assert mag.shape == want_mag.shape == (500, 1 + 20_000 // 256)
    assert phase.dtype == want_phase.dtype == np.complex64
    np.testing.assert_allclose(mag, want_mag, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(mag * phase, want_mag * want_phase, atol=ATOL)


def test_launch_refuses_a_cpu_tensor_on_the_mixed_route():
    with pytest.raises(ValueError, match="CUDA"):
        cdsp.launch(torch.zeros(4096), 999, 256, True, "mixed")
    with pytest.raises(ValueError, match="mixed route takes"):
        cdsp.launch(torch.zeros(4096), 1024, 256, True, "mixed")
    with pytest.raises(ValueError, match="gemm route takes an even"):
        cdsp.launch(torch.zeros(4096), 999, 256, True, "gemm")

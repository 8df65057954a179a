"""The host-side layouts of the MR-STFT loss kernels (CPU).

``svs_torch/csrc/spectral.cuh`` reads its bases pre-tiled, in the order
and the 128-byte swizzled layout its stages consume
(``spectral.dft_tiles`` in both directions, ``spectral.shift_tiles`` in the
backward's adjoint), and stages signal spans sized from
``spectral.Geometry``.  These tests undo the tiling and
check it against the plain bases, rebuild the adjoint's shift formulation
from the tiles and hold it against ``spectral.adjoint_plain``, and check
the geometry's bounds on what the kernels read.  The kernels themselves run
only on the card (tests/test_torch_cuda.py).

Tolerances: the tiles are the bf16 basis moved, so they are compared
exactly; the shift-form adjoint and ``adjoint_plain`` sum the same float32
products in another order, so they agree to 1e-5 of the largest value.
"""

import numpy as np
import pytest
import torch

from svs_torch.ops.cuda import spectral as sp

# the train step's three resolutions, an odd ``left``, a window as wide as
# the frame, and hops that take the 64-wide adjoint tiles
GEOMETRIES = [(1024, 120, 600), (2048, 240, 1200), (512, 50, 240),
              (1024, 120, 598), (512, 120, 512), (256, 64, 200),
              (512, 100, 300)]


def _unswizzle(t):
    return sp.swizzle128(t)  # the swizzle is its own inverse


@pytest.mark.parametrize("n_fft,hop,win", GEOMETRIES)
def test_grad_tiles_untile_to_the_basis_taps(n_fft, hop, win):
    geo = sp.Geometry(2, 4000, n_fft, hop, win)
    tiles = sp.dft_tiles(geo, "cpu")
    assert tiles.shape == (n_fft // 128, geo.n_taps // 64, 128, 64)
    # (col tile, stage, col, tap) -> (col, tap)
    cols = _unswizzle(tiles).transpose(1, 2).reshape(n_fft, geo.n_taps)
    basis = sp.basis_bf16(n_fft, win, "cpu")
    want = torch.zeros((geo.n_taps, n_fft), dtype=torch.bfloat16)
    n = min(geo.n_taps, n_fft - geo.tap_lo)
    want[:n] = basis[geo.tap_lo:geo.tap_lo + n]
    assert torch.equal(cols, want.T)
    # the taps cover the window, and the basis is zero outside it
    assert geo.tap_lo % 8 == 0 and geo.tap_lo <= geo.left
    assert geo.tap_lo + geo.n_taps >= geo.left + win
    assert float(basis.float()[:geo.tap_lo].abs().sum()) == 0.0
    assert float(basis.float()[geo.tap_lo + n:].abs().sum()) == 0.0


def test_swizzle_moves_16_byte_chunks_by_row():
    t = torch.arange(16 * 64, dtype=torch.float32).reshape(16, 64)
    s = sp.swizzle128(t)
    for r in range(16):
        for c in range(8):
            assert torch.equal(s[r, 8 * (c ^ (r % 8)):8 * (c ^ (r % 8)) + 8],
                               t[r, 8 * c:8 * c + 8])
    assert torch.equal(sp.swizzle128(s), t)


def _adjoint_from_shift_tiles(g_cols, geo):
    """The adjoint kernel's sum, from the un-tiled shift tiles: hop row r
    column c of the padded signal's cotangent is
    sum_j G[r - j] . basis[j*hop + c] over the shifts that meet the
    window; then the fold."""
    tiles = _unswizzle(sp.shift_tiles(geo, "cpu")).float()
    # (hop tile, chunk, shift, row, 64) -> (shift, hop tile * width, n_fft)
    w = tiles.permute(2, 0, 3, 1, 4).reshape(
        geo.n_shifts, geo.hop_tiles * geo.hop_width, geo.n_fft)[:, :geo.hop]
    rows = torch.zeros((geo.batch, geo.rows, geo.hop))
    for j in range(geo.n_shifts):
        shift = geo.shift_lo + j
        rows[:, shift:shift + geo.n_frames] += g_cols @ w[j].T
    return sp.fold_rows(rows, geo)


@pytest.mark.parametrize("n_fft,hop,win", GEOMETRIES)
def test_shift_tiles_give_the_plain_adjoint(n_fft, hop, win):
    geo = sp.Geometry(2, 3000, n_fft, hop, win)
    rng = np.random.default_rng(n_fft + hop + win)
    g_cols = torch.from_numpy(rng.standard_normal(
        (2, geo.n_frames, n_fft)).astype(np.float32))
    got = _adjoint_from_shift_tiles(g_cols, geo)
    want = sp.adjoint_plain(g_cols, geo)
    assert got.shape == want.shape == (2, 3000)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("n_fft,hop,win", GEOMETRIES)
def test_backward_reads_stay_inside_the_padded_row(n_fft, hop, win):
    """Forward and backward read one tap range; the DFT GEMM's reads of it,
    and the adjoint's rows, stay inside what the wrappers allocate."""
    for t in (n_fft // 2 + 1, 1000, 9001, 97_536):
        geo = sp.Geometry(1, t, n_fft, hop, win)
        # the last frame's taps stay inside the row, from the base the
        # kernels get (tap_base: tap_lo, 16-byte aligned) to the row length
        # they are told (the arguments of dft_args)
        row_len = sp.dft_args(geo, "cpu")[2]
        assert row_len == geo.stride - geo.tap_lo and row_len % 8 == 0
        assert (geo.n_frames - 1) * hop + geo.n_taps <= row_len
        assert geo.stride % 8 == 0 and geo.tap_lo % 8 == 0
        assert geo.n_taps % sp.STAGE == 0
        # a block's staged span covers its 64 frames' taps from its
        # offset aligned down to 8
        assert (sp.dft_span(hop, geo.n_taps)
                >= 7 + (sp.DFT_FRAMES - 1) * hop + geo.n_taps)
        # the adjoint's rows cover the frames' span (the padded signal's
        # last t_padded % hop samples, if any, lie in no frame)
        assert geo.rows * hop >= (geo.n_frames - 1) * hop + n_fft
        assert geo.hop_tiles * geo.hop_width >= hop


def test_adjoint_widths():
    widths = {hop: sp.Geometry(1, 9000, 1024, hop, 600).hop_width
              for hop in (50, 120, 240, 64, 100, 256)}
    assert widths == {50: 56, 120: 120, 240: 240, 64: 64, 100: 64, 256: 64}
    geo = sp.Geometry(1, 9000, 1024, 100, 600)
    assert geo.hop_tiles == 2


def test_train_shapes_fit_the_kernels_shared_memory():
    """The DFT GEMM stages one signal span (two for loss_partials) of
    (64 - 1)*hop + n_taps samples beside a 4-stage ring of 16 KB; the
    adjoint a ring of 4 shift tiles and three cotangent chunks of 128 rows:
    all within the H100's 227 KB a block (other geometries stage their
    frames in pieces or their shifts in groups), by spectral.py's mirror
    of the C++ sizes, which is held here against the sizes worked out by
    hand."""
    for n_fft, hop, win in [(1024, 120, 600), (2048, 240, 1200),
                            (512, 50, 240)]:
        geo = sp.Geometry(32, 97_536, n_fft, hop, win)
        span = -(-(7 + 63 * hop + geo.n_taps) // 64) * 64
        assert sp.dft_span(hop, geo.n_taps) == span
        dft = 1024 + 4 * 16384 + max(2 * span * 2, 64 * 136 * 2) + 72
        adj = (1024 + 4 * geo.hop_width * 128
               + 3 * (128 + geo.n_shifts - 1) * 128 + 128 + 112)
        assert sp.dft_smem(2, span) == dft
        assert sp.adj_smem(geo.hop_width, geo.n_shifts) == adj
        assert dft <= sp.SMEM_LIMIT == 232_448 and adj <= 232_448

"""The port's losses (``svs_torch.losses``) against svs_tpu's on the CPU.

Values and gradients (with respect to the prediction, or the mask) go
through both packages from the same numpy-seeded inputs.  Tolerances:
- ``fft`` and the L1 terms, float32: 1e-5 relative on values and 1e-4 on
  gradients (float32 FFTs and sums in different orders, pocketfft against
  XLA's FFT);
- ``matmul_bf16`` and the kernel-backed names (``pallas_*``, plain versions
  here): 1e-3 relative on values, and gradients to max|d|/max|g| < 2e-2
  with cosine > 0.9999; the DFTs round operands (and, for ``matmul_bf16``,
  their outputs) to bf16 on both sides, where one f32 ulp of difference
  before a rounding moves a value by a bf16 ulp (2^-8), and the sums
  average those flips out (tests/test_fused_loss.py's bounds).
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp

from svs_torch.losses import masked_l1 as tl1
from svs_torch.losses import mrstft as tmr
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.losses import masked_l1 as jl1
from svs_tpu.losses import mrstft as jmr
from svs_tpu.ops.pallas import diff_mag as jdm
from svs_tpu.ops.pallas import fused_loss as jfl
from svs_tpu.utils.config import SVSConfig as JConfig

IMPLS = ["fft", "matmul_bf16", "pallas_bf16", "pallas_fused",
         "pallas_fused_wide"]


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


def _arr(seed, shape, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _patches(seed, b=2, t=16):
    rng = np.random.default_rng(seed)
    mix = rng.random((b, 512, t)).astype(np.float32)
    voc = (mix * rng.random((b, 512, t))).astype(np.float32)
    ang = lambda: rng.uniform(-np.pi, np.pi, (b, 512, t)).astype(np.float32)
    mask = rng.random((b, 512, t)).astype(np.float32)
    return mask, mix, voc, ang(), ang()


def _torch_grad(fn, *args):
    args = [torch.from_numpy(a) for a in args]
    args[0].requires_grad_()
    out = fn(*args)
    out.backward()
    return float(out.detach()), args[0].grad.numpy()


def _close(got, want, exact):
    (gv, gg), (wv, wg) = got, want
    if exact:
        np.testing.assert_allclose(gv, wv, rtol=1e-5)
        np.testing.assert_allclose(gg, wg, rtol=1e-4,
                                   atol=1e-4 * np.abs(wg).max())
        return
    np.testing.assert_allclose(gv, wv, rtol=1e-3)
    assert np.abs(gg - wg).max() / np.abs(wg).max() < 2e-2
    cos = (gg * wg).sum() / (np.linalg.norm(gg) * np.linalg.norm(wg))
    assert cos > 0.9999


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_l1_pair_matches_jax(weighted):
    mask, mix, voc, _, _ = _patches(0, b=3)
    w = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None

    def jfn(m):
        return jl1.masked_l1_pair(m, mix, voc,
                                  None if w is None else jnp.asarray(w))[0]

    want = (float(jfn(jnp.asarray(mask))),
            np.asarray(jax.grad(jfn)(jnp.asarray(mask))))
    got = _torch_grad(lambda m, a, b: tl1.masked_l1_pair(
        m, a, b, None if w is None else torch.from_numpy(w))[0],
        mask, mix, voc)
    _close(got, want, exact=True)


def test_weighted_l1_matches_jax():
    mask, mix, voc, _, _ = _patches(1)
    for reduction in ("mean", "sum", "none"):
        want = np.asarray(jl1.weighted_l1(voc, mix, mask, reduction))
        got = tl1.weighted_l1(torch.from_numpy(voc), torch.from_numpy(mix),
                              torch.from_numpy(mask), reduction).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_patch_istft_matches_jax():
    _, mix, _, ang, _ = _patches(2)
    want = np.asarray(jmr.patch_istft(jnp.asarray(mix), jnp.asarray(ang)))
    got = tmr.patch_istft(torch.from_numpy(mix), torch.from_numpy(ang))
    assert got.shape == want.shape == (2, 768 * 15)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("impl", IMPLS)
def test_stft_loss_matches_jax(impl):
    x, y = _arr(3, (2, 11_520)), _arr(4, (2, 11_520))

    def jfn(v):
        return jmr.stft_loss(v, jnp.asarray(y), 512, 50, 240, impl=impl)

    want = (float(jfn(jnp.asarray(x))),
            np.asarray(jax.grad(jfn)(jnp.asarray(x))))
    got = _torch_grad(lambda v, t: tmr.stft_loss(v, t, 512, 50, 240,
                                                 impl=impl), x, y)
    _close(got, want, exact=impl == "fft")


@pytest.mark.parametrize("impl", ["fft", "matmul_bf16", "pallas_fused"])
def test_weighted_stft_loss_matches_jax(impl):
    x, y = _arr(5, (3, 9_000)), _arr(6, (3, 9_000))
    w = np.array([1.0, 1.0, 0.0], np.float32)
    want = float(jmr.stft_loss(jnp.asarray(x), jnp.asarray(y), 1024, 120,
                               600, impl=impl, weight=jnp.asarray(w)))
    got = float(tmr.stft_loss(torch.from_numpy(x), torch.from_numpy(y),
                              1024, 120, 600, impl=impl,
                              weight=torch.from_numpy(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5 if impl == "fft"
                               else 1e-3)


@pytest.mark.parametrize("impl", ["fft", "matmul_bf16"])
def test_combined_loss_matches_jax(impl):
    """The whole loss of a train step (L1 pair + patch iSTFT + MR-STFT),
    value and gradient with respect to the mask."""
    mask, mix, voc, mix_a, voc_a = _patches(7)
    jcfg, tcfg = JConfig(mr_mag_impl=impl), TConfig(mr_mag_impl=impl)

    def jfn(m):
        return jmr.combined_loss(m, mix, voc, mix_a, voc_a, jcfg)[0]

    want = (float(jfn(jnp.asarray(mask))),
            np.asarray(jax.grad(jfn)(jnp.asarray(mask))))
    got = _torch_grad(lambda m, a, b, c, d: tmr.combined_loss(
        m, a, b, c, d, tcfg)[0], mask, mix, voc, mix_a, voc_a)
    _close(got, want, exact=impl == "fft")
    _, aux = tmr.combined_loss(*(torch.from_numpy(a) for a in
                                 (mask, mix, voc, mix_a, voc_a)), tcfg)
    assert set(aux) == {"l1", "mr", "total"}


def test_mr_stft_loss_kernel_names_agree_with_matmul():
    """The kernel-backed names land on the matmul path's value (rtol 5e-3,
    tests/test_fused_loss.py:95)."""
    x = torch.from_numpy(_arr(8, (2, 11_520)))
    y = x * 0.8 + 0.01
    want = float(tmr.mr_stft_loss(x, y, impl="matmul_bf16"))
    for impl in ("pallas_bf16", "pallas_fused", "pallas_fused_wide"):
        np.testing.assert_allclose(float(tmr.mr_stft_loss(x, y, impl=impl)),
                                   want, rtol=5e-3)


@pytest.mark.parametrize("impl", IMPLS)
def test_perfect_prediction_is_zero_safe(impl):
    """x == y: the SC numerator is exactly 0, and the double-where roots
    keep the gradient finite.  What is left is the log-magnitude L1's
    subgradient at its ties: +1 for |.| (the magnitude paths, on both
    sides) and sign(0) = 0 in the fused kernel, whose gradient is then
    exactly zero on both sides."""
    x = _arr(9, (2, 9_000))

    def jfn(v):
        return jmr.stft_loss(v, jnp.asarray(x), 1024, 120, 600, impl=impl)

    want = (float(jfn(jnp.asarray(x))),
            np.asarray(jax.grad(jfn)(jnp.asarray(x))))
    got = _torch_grad(lambda v, t: tmr.stft_loss(v, t, 1024, 120, 600,
                                                 impl=impl), x, x.copy())
    assert got[0] == want[0] == 0.0
    assert np.isfinite(got[1]).all() and np.isfinite(want[1]).all()
    if impl.startswith("pallas_fused"):
        assert (got[1] == 0).all() and (want[1] == 0).all()
    else:
        _close((1.0, got[1]), (1.0, want[1]), exact=impl == "fft")


def test_abs_has_jax_derivative_at_zero():
    x = torch.zeros(3, requires_grad=True)
    tl1.abs_like_jax(x).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.abs(v)))(jnp.zeros(3))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))

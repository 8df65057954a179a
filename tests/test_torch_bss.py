"""BSS eval in the port: ``svs_torch.evaluation.bss`` (the numpy reference,
a copy of svs_tpu's) and ``svs_torch.evaluation.bss_torch`` (one batched
torch program, float64), against svs_tpu's ``bss.py`` and ``bss_jax.py``
on the CPU.  Both sides solve the same float64 systems, so the metrics
agree to 1e-9 dB (tests/test_bss_jax.py's bound for svs_tpu's own device
path against its numpy one).
"""

import logging

import numpy as np
import pytest
import torch

from svs_torch.evaluation import bss as tbss
from svs_torch.evaluation import bss_torch
from svs_tpu.evaluation import bss as jbss
from svs_tpu.evaluation import bss_jax


def _material(seed, t=5000):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(t)
    a = rng.standard_normal(t) * 0.5
    mix = v + a
    est = v + 0.1 * rng.standard_normal(t) + 0.05 * a
    return mix, v, est


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("swap", [False, True], ids=["in_order", "swapped"])
def test_sources_match_svs_tpus_numpy_and_jax_paths(swap):
    mix, v, est = _material(0)
    refs = np.stack([v, mix - v])
    ests = np.stack([est, mix - est])
    if swap:
        ests = ests[::-1]
    want = jbss.bss_eval_sources(refs, ests)
    _close(tbss.bss_eval_sources(refs, ests), want)
    got = bss_torch.bss_eval_sources(refs, ests, device="cpu")
    _close(got, want)
    _close(got, bss_jax.bss_eval_sources(refs, ests, dtype="float64"))
    assert list(got[3]) == ([1, 0] if swap else [0, 1])
    diag = bss_torch.bss_eval_sources(refs, ests, compute_permutation=False,
                                      device="cpu")
    _close(diag, jbss.bss_eval_sources(refs, ests,
                                       compute_permutation=False))


def test_track_metrics_match_on_correlated_material():
    """A musical bed shared by both sources: worse Gram conditioning than
    white noise."""
    rng = np.random.default_rng(1)
    t = np.arange(6000) / 8192.0
    bed = np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 440 * t)
    v = 0.7 * bed + 0.3 * rng.standard_normal(t.size)
    a = 0.6 * bed + 0.4 * rng.standard_normal(t.size)
    mix = v + a
    est = v + 0.2 * a + 0.05 * rng.standard_normal(t.size)
    want = jbss.compute_metrics_for_track(mix, v, est)
    assert tbss.compute_metrics_for_track(mix, v, est) == want
    got = bss_torch.compute_metrics_for_track(mix, v, est, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-9, k


def test_trailing_zero_padding_changes_nothing():
    """Lengths in one FFT bucket are padded to the same length: the cut
    signals' metrics are the numpy reference's for the cut signals."""
    mix, v, est = _material(2)
    refs = np.stack([v, mix - v])
    ests = np.stack([est, mix - est])
    assert (bss_torch._bucket_len(4500, 512)
            == bss_torch._bucket_len(5000, 512) == 7681)
    cut = bss_torch.bss_eval_sources(refs[:, :4500], ests[:, :4500],
                                     device="cpu")
    _close(cut, jbss.bss_eval_sources(refs[:, :4500], ests[:, :4500]))
    full = bss_torch.bss_eval_sources(refs, ests, device="cpu")
    assert not np.allclose(cut[0], full[0])


def test_validation_is_the_numpy_paths():
    v = np.random.default_rng(3).standard_normal(1000)
    with pytest.raises(ValueError, match="shapes differ"):
        bss_torch.bss_eval_sources(np.stack([v, v]), v[None, :500],
                                   device="cpu")
    with pytest.raises(ValueError, match="all-silent"):
        bss_torch.bss_eval_sources(np.stack([v, np.zeros(1000)]),
                                   np.stack([v, v]), device="cpu")


def test_a_broken_solve_falls_back_to_numpy_and_warns(monkeypatch, caplog):
    """A NaN from the device program sends the call to the numpy reference,
    counted and logged, never returned."""
    mix, v, est = _material(4, t=3000)
    refs = np.stack([v, mix - v])
    ests = np.stack([est, mix - est])
    real = bss_torch._metric_matrices

    def nan_sdr(*args):
        sdr, sir, sar = real(*args)
        return sdr * float("nan"), sir, sar

    monkeypatch.setattr(bss_torch, "_metric_matrices", nan_sdr)
    before = bss_torch.fallbacks
    with caplog.at_level(logging.WARNING, logger=bss_torch.__name__):
        got = bss_torch.bss_eval_sources(refs, ests, device="cpu")
    assert bss_torch.fallbacks == before + 1
    assert "falls back to the numpy reference" in caplog.text
    _close(got, jbss.bss_eval_sources(refs, ests))


def test_a_singular_gram_falls_back_to_numpy():
    """The second reference is the first delayed by one sample, so the
    delayed-reference subspaces coincide and the joint Gram matrix is
    singular: numpy's path takes lstsq (bss.py:62-64), the device path
    must hand over and never return garbage (svs_tpu's test)."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal(3000)
    r2 = np.roll(v, 1)
    r2[0] = 0.0
    refs = np.stack([v, r2])
    est = v + 0.01 * rng.standard_normal(3000)
    ests = np.stack([est, np.roll(est, 1)])
    want = jbss.bss_eval_sources(refs, ests)
    got = bss_torch.bss_eval_sources(refs, ests, device="cpu")
    for a, b in zip(got, want):
        arr = np.asarray(a, float)
        assert np.all(np.isfinite(arr) | np.isinf(arr))
        np.testing.assert_allclose(arr, np.asarray(b, float), rtol=1e-6,
                                   atol=1e-6)


def test_float64_on_the_device_it_is_given(monkeypatch):
    seen = []
    real = bss_torch._metric_matrices

    def spy(refs, ests, flen):
        seen.append((refs.dtype, refs.device.type))
        return real(refs, ests, flen)

    monkeypatch.setattr(bss_torch, "_metric_matrices", spy)
    mix, v, est = _material(6, t=2000)
    bss_torch.compute_metrics_for_track(mix, v, est, device="cpu")
    assert seen == [(torch.float64, "cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bss_torch.compute_metrics_for_track(mix, v, est)

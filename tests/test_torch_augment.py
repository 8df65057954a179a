"""The port's remix augmentation (``svs_torch.data.augment``) against
svs_tpu's on the CPU.

Both draw their vectors on the host from the same numpy generator, so the
partner permutation and the gains are bit-identical; the remix itself is
float32 trigonometry on both sides (XLA's against PyTorch's), so the planes
agree to rtol 1e-5 / atol 1e-5 (magnitudes of order 1), the target
magnitude ``voc`` (a gain times a gathered row, no trigonometry) exactly,
and angles are compared as points on the unit circle (a value near ±π may
land on either side of the branch cut).  The numpy oracle computes in
complex128, so the port meets it within the same bounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svs_torch.data import augment as taug
from svs_tpu.data import augment as jaug


def _batch(seed, b=6, f=16, t=8, n_pad=0):
    rng = np.random.default_rng(seed)
    mix = rng.random((b, f, t)).astype(np.float32)
    voc = (mix * rng.random((b, f, t))).astype(np.float32)
    ang = lambda: rng.uniform(-np.pi, np.pi, (b, f, t)).astype(np.float32)
    batch = {"mix": mix, "voc": voc, "mix_angle": ang(), "voc_angle": ang(),
             "weight": np.ones(b, np.float32)}
    if n_pad:
        for k in ("mix", "voc", "mix_angle", "voc_angle"):
            batch[k][b - n_pad:] = 0.0
        batch["weight"][b - n_pad:] = 0.0
    return batch


def _close(got, want):
    got = {k: np.asarray(v) for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["mix"], want["mix"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["voc_angle"], want["voc_angle"])
    np.testing.assert_array_equal(got["weight"], want["weight"])
    for k in ("mix_angle",):
        np.testing.assert_allclose(np.cos(got[k]), np.cos(want[k]),
                                   atol=2e-5)
        np.testing.assert_allclose(np.sin(got[k]), np.sin(want[k]),
                                   atol=2e-5)


def test_draws_are_svs_tpus():
    for n_real in (6, 4):
        a = taug.draw_vectors(np.random.default_rng(3), n_real, 6, 0.5,
                              0.25, 1.25)
        b = jaug.draw_vectors(np.random.default_rng(3), n_real, 6, 0.5,
                              0.25, 1.25)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(taug.draw_epoch(np.random.default_rng(4), 3, 6, 0.5,
                                    0.25, 1.25),
                    jaug.draw_epoch(np.random.default_rng(4), 3, 6, 0.5,
                                    0.25, 1.25)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_pad", [0, 2])
def test_augmenter_batches_equal_svs_tpus(n_pad):
    """One epoch seed, three steps: the same vectors, the same planes; pad
    rows stay exactly zero."""
    b = 6
    t_aug = taug.Augmenter(0.7, 0.3, 1.2).for_epoch(11)
    j_aug = jaug.Augmenter(0.7, 0.3, 1.2).for_epoch(11)
    for step in range(3):
        batch = _batch(step, b=b, n_pad=n_pad)
        got = t_aug({k: torch.from_numpy(v) for k, v in batch.items()},
                    n_real=b - n_pad)
        want = j_aug({k: jnp.asarray(v) for k, v in batch.items()},
                     n_real=b - n_pad)
        _close({k: v.numpy() for k, v in got.items()}, want)
        np.testing.assert_array_equal(got["voc"].numpy(),
                                      np.asarray(want["voc"]))
        if n_pad:
            for k in ("mix", "voc", "mix_angle", "voc_angle"):
                assert not got[k][b - n_pad:].any(), k


def test_apply_remix_equals_the_numpy_oracle():
    batch = _batch(5)
    perm, g_voc, g_acc = taug.draw_vectors(np.random.default_rng(6), 6, 6,
                                           1.0, 0.25, 1.25)
    got = taug.apply_remix({k: torch.from_numpy(v) for k, v in
                            batch.items()}, torch.from_numpy(perm).long(),
                           torch.from_numpy(g_voc), torch.from_numpy(g_acc))
    want = taug.apply_remix_np(batch, perm, g_voc, g_acc)
    _close({k: v.numpy() for k, v in got.items()}, want)
    np.testing.assert_allclose(got["voc"].numpy(), want["voc"], rtol=1e-6)


def test_host_mode_is_the_oracle_and_bad_arguments_raise():
    batch = _batch(7)
    host = taug.Augmenter(host=True).for_epoch(2)(batch)
    vectors = taug.draw_vectors(
        np.random.default_rng(2 * 1_000_003 + 17), 6, 6, 0.5, 0.25, 1.25)
    want = taug.apply_remix_np(batch, *vectors)
    for k in want:
        np.testing.assert_array_equal(host[k], want[k])
    with pytest.raises(RuntimeError, match="for_epoch"):
        taug.Augmenter()(batch)
    with pytest.raises(ValueError, match="n_real"):
        taug.Augmenter().for_epoch(0)(batch, n_real=0)
    with pytest.raises(ValueError, match="remix_p"):
        taug.Augmenter(remix_p=1.5)
    with pytest.raises(ValueError, match="gain_lo"):
        taug.Augmenter(gain_lo=2.0, gain_hi=1.0)

"""The port's U-Net against svs_tpu ``unet.apply`` on the same weights.

Weights are made by svs_tpu's ``unet.init`` (plus random BN statistics) and
cross with ``torch_import.state_dict_from_jax``.  Tolerances:
- float32 compute: 1e-5 on the sigmoid mask (f32 convs in different
  summation orders, ~1e-6 observed);
- bfloat16 compute: 1e-2 on the mask.  Both sides round conv outputs and
  every activation to bf16 (8 bits of mantissa, 4e-3 relative), but XLA's
  CPU backend may keep a fused elementwise chain in f32 where torch rounds
  after each op, so single activations can differ by a bf16 ulp and the
  difference grows through 12 layers (~2e-3 observed at this size).
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp

from svs_torch.models import torch_import as t_import
from svs_torch.models.unet import UNet, param_count
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.models import torch_import as j_import
from svs_tpu.models import unet as junet
from svs_tpu.utils.config import SVSConfig as JConfig

NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16))


# one compiled program instead of ~50 eagerly dispatched random ops
_init = jax.jit(junet.init, static_argnums=1)


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


def _jax_weights(cfg, seed=0):
    params, state = _init(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed)
    state = jax.tree.map(np.asarray, state)
    for lvl in state["enc"] + state["dec"]:
        lvl["mean"] = (rng.standard_normal(lvl["mean"].shape) * 0.3).astype(
            np.float32)
        lvl["var"] = (rng.random(lvl["var"].shape) + 0.5).astype(np.float32)
    return jax.tree.map(np.asarray, params), state


def _models(dtype="float32", **kw):
    jcfg = JConfig(compute_dtype=dtype, **NARROW, **kw)
    tcfg = TConfig(compute_dtype=dtype, **NARROW, **kw)
    params, state = _jax_weights(jcfg)
    model = UNet(tcfg)
    model.load_state_dict(t_import.state_dict_from_jax(params, state))
    return jcfg, params, state, model


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 1e-2)])
def test_eval_forward_matches_jax(rng, dtype, atol):
    jcfg, params, state, model = _models(dtype)
    x = rng.random((2, 512, 128)).astype(np.float32)
    want, _ = junet.apply(params, state, jnp.asarray(x), train=False,
                          cfg=jcfg)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 512, 128)
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.max() < atol, err.max()
    if dtype == "bfloat16":
        assert np.median(err) < 1e-3


def test_train_mode_bn_with_weight_mask_matches_jax(rng):
    """Train-mode BatchNorm: batch statistics over the real rows of a
    padded batch, running stats updated as torch does; dropout off."""
    jcfg, params, state, model = _models(dropout_rate=0.0)
    x = rng.random((3, 512, 64)).astype(np.float32)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    want, new_state = junet.apply(params, state, jnp.asarray(x), train=True,
                                  dropout_rng=jax.random.key(1), cfg=jcfg,
                                  weight=jnp.asarray(w))
    got = model.train()(torch.from_numpy(x), weight=torch.from_numpy(w))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    sd = model.state_dict()
    for i, s in enumerate(new_state["enc"], start=1):
        np.testing.assert_allclose(sd[f"conv{i}.1.running_mean"].numpy(),
                                   np.asarray(s["mean"]), atol=1e-5)
        np.testing.assert_allclose(sd[f"conv{i}.1.running_var"].numpy(),
                                   np.asarray(s["var"]), atol=1e-5)
    for i, s in enumerate(new_state["dec"], start=1):
        np.testing.assert_allclose(
            sd[f"deconv{i}_BAD.0.running_var"].numpy(),
            np.asarray(s["var"]), atol=1e-5)


def test_dropout2d_drops_whole_channels():
    cfg = TConfig(**NARROW)
    model = UNet(cfg, generator=torch.Generator().manual_seed(0)).train()
    x = torch.rand(2, 512, 64)
    g = torch.Generator().manual_seed(3)
    a = model(x, generator=g)
    b = model(x, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)  # the generator alone decides the masks
    from svs_torch.models.unet import dropout2d
    y = dropout2d(torch.ones(4, 6, 5, 7), 0.5, torch.Generator().manual_seed(0))
    per_channel = y.flatten(2)
    assert ((per_channel == 0).all(-1) | (per_channel == 2.0).all(-1)).all()


def test_state_dict_keys_are_the_reference_keys():
    params, state = _jax_weights(JConfig())
    want = j_import.params_to_state_dict(params, state)
    model = UNet(TConfig())
    assert sorted(model.state_dict()) == sorted(want)
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == np.shape(want[k]), k
    assert param_count(model) == junet.param_count(params)


def test_pth_round_trip_through_both_packages(rng, tmp_path):
    jcfg, params, state, model = _models()
    x = rng.random((1, 512, 128)).astype(np.float32)
    # port -> .pth -> svs_tpu
    path = str(tmp_path / "port.pth")
    t_import.save_pth(path, model)
    p2, s2, _ = j_import.load_pth(path)
    want, _ = junet.apply(p2, s2, jnp.asarray(x), cfg=jcfg)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # svs_tpu -> .pth (its exporter's key set) -> port
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          j_import.params_to_state_dict(params, state).items()}
    path2 = str(tmp_path / "jax.pth")
    torch.save({"model_state_dict": sd, "epoch": 3}, path2)
    sd2, extras = t_import.load_pth(path2)
    assert extras == {"epoch": 3}
    model2 = UNet(model.cfg)
    model2.load_state_dict(sd2)
    with torch.no_grad():
        got2 = model2.eval()(torch.from_numpy(x))
    torch.testing.assert_close(got2, got, atol=0, rtol=0)


def test_layout_conversions_match_jax(rng):
    w = rng.standard_normal((5, 5, 3, 4)).astype(np.float32)
    for name in ("conv_weight_from_hwio", "deconv_weight_from_hwio",
                 "conv_weight_to_hwio", "deconv_weight_to_hwio"):
        np.testing.assert_array_equal(getattr(t_import, name)(w),
                                      getattr(j_import, name)(w))


def test_seeded_init_is_reproducible_and_in_bounds():
    cfg = TConfig(**NARROW)
    a = UNet(cfg, generator=torch.Generator().manual_seed(5))
    b = UNet(cfg, generator=torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.conv2[0].weight
    assert w.abs().max() <= 1.0 / (4 * 25) ** 0.5

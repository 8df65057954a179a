"""The port's train and eval steps (``svs_torch.train.step``) against
svs_tpu's on the CPU, on the narrow U-Net.

Weights are made by svs_tpu's ``create_train_state`` and cross with
``torch_import.state_dict_from_jax``; batches are numpy-seeded (B = 2,
(512, 128) patches) and ``dropout_rate = 0`` (jax.random and
torch.Generator draw different masks).  Bounds (``__graft_entry__.py``'s
envelope for one step against another implementation of it):
- f32 at ``fft``: loss <= 1e-5 relative, grad_norm <= 1e-3 relative, BN
  running statistics < 1e-4 (float32 convs and FFTs summed in other
  orders);
- after Adam: the first step moves each parameter by about lr*sign(g), so a
  parameter whose gradient is ~0 can land 2*lr away when the two sides
  round its sign differently: max |d| <= 2.1*lr, mean |d| < 2e-4;
- ``pallas_fused`` (plain version here, the Pallas kernel in interpret
  mode there): loss <= 1e-4 relative and grad_norm <= 2e-2 relative, the
  bf16 bounds of tests/test_torch_losses.py carried through the U-Net.
"""

import dataclasses

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp

from svs_torch.models import torch_import as t_import
from svs_torch.models.unet import UNet
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.models import unet as junet
from svs_tpu.ops.pallas import fused_loss as jfl
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), dropout_rate=0.0)


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


def _batch(seed, b=2, t=128):
    rng = np.random.default_rng(seed)
    mix = rng.random((b, 512, t)).astype(np.float32)
    voc = (mix * rng.random((b, 512, t))).astype(np.float32)
    ang = lambda: rng.uniform(-np.pi, np.pi, (b, 512, t)).astype(np.float32)
    return {"mix": mix, "voc": voc, "mix_angle": ang(), "voc_angle": ang()}


def _pair(accum_steps=1, **kw):
    """The same initial weights in both packages: (jax cfg, jax state, jax
    optimizer, port cfg, port state)."""
    jcfg, tcfg = JConfig(**NARROW, **kw), TConfig(**NARROW, **kw)
    jopt = jstep.make_optimizer(jcfg, accum_steps)
    jstate = jstep.create_train_state(jax.random.key(0), jcfg, jopt)
    tstate = tstep.create_train_state(0, tcfg,
                                      tstep.make_optimizer(tcfg, accum_steps),
                                      device="cpu")
    tstate.model.load_state_dict(_state_dict(jstate))
    return jcfg, jstate, jopt, tcfg, tstate


def _state_dict(jstate):
    return t_import.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state))


def _jax_step(jcfg, jopt, jstate, batch):
    step = jstep.make_train_step(jcfg, jopt)
    return step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.key(1))


def _torch_step(tcfg, tstate, batch):
    return tstep.make_train_step(tcfg)(
        tstate, tstep.batch_to_device(batch, "cpu"),
        torch.Generator().manual_seed(1))


def _deltas(want_sd, model):
    got = model.state_dict()
    bn, params = 0.0, []
    for k, w in want_sd.items():
        d = np.abs(got[k].numpy() - w.numpy())
        if "running" in k:
            bn = max(bn, float(d.max()))
        elif "num_batches" not in k:
            params.append(d)
    flat = np.concatenate([d.ravel() for d in params])
    return bn, float(flat.max()), float(flat.mean())


def _check_step(jaux, jstate, taux, tstate, lr, loss_rtol, gn_rtol):
    for k in ("l1", "mr", "total"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=loss_rtol)
    np.testing.assert_allclose(float(taux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=gn_rtol)
    bn, pmax, pmean = _deltas(_state_dict(jstate), tstate.model)
    assert bn < 1e-4
    assert pmax <= 2.1 * lr and pmean < 2e-4, (pmax, pmean)


def test_f32_fft_step_matches_jax():
    jcfg, jstate, jopt, tcfg, tstate = _pair(mr_mag_impl="fft")
    batch = _batch(0)
    jstate, jaux = _jax_step(jcfg, jopt, jstate, batch)
    tstate, taux = _torch_step(tcfg, tstate, batch)
    assert tstate.step == int(jstate.step) == 1
    assert set(taux) == {"l1", "mr", "total", "grad_norm"}
    _check_step(jaux, jstate, taux, tstate, tcfg.learning_rate, 1e-5, 1e-3)


def test_pallas_fused_step_matches_jax():
    jfl._INTERPRET = True
    try:
        jcfg, jstate, jopt, tcfg, tstate = _pair(mr_mag_impl="pallas_fused")
        batch = _batch(1)
        jstate, jaux = _jax_step(jcfg, jopt, jstate, batch)
    finally:
        jfl._INTERPRET = False
    tstate, taux = _torch_step(tcfg, tstate, batch)
    _check_step(jaux, jstate, taux, tstate, tcfg.learning_rate, 1e-4, 2e-2)


def test_accumulation_matches_multisteps():
    """accum_steps=2: parameters and Adam's count stay after microbatch 1
    (BN running stats move), and after microbatch 2 equal optax.MultiSteps'
    update with the mean gradient."""
    jcfg, jstate, jopt, tcfg, tstate = _pair(accum_steps=2,
                                             mr_mag_impl="fft")
    start = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    b1, b2 = _batch(2), _batch(3)
    jstate, _ = _jax_step(jcfg, jopt, jstate, b1)
    tstate, _ = _torch_step(tcfg, tstate, b1)
    assert tstate.mini_step == 1 and not tstate.optimizer.state
    for k, v in tstate.model.state_dict().items():
        if "running" in k or "num_batches" in k:
            continue
        assert torch.equal(v, start[k]), k
    assert not torch.equal(tstate.model.conv1[1].running_mean,
                           start["conv1.1.running_mean"])
    jstate, jaux = _jax_step(jcfg, jopt, jstate, b2)
    tstate, taux = _torch_step(tcfg, tstate, b2)
    assert tstate.mini_step == 0 and tstate.step == 2
    _check_step(jaux, jstate, taux, tstate, tcfg.learning_rate, 1e-5, 1e-3)
    tstep.reset_accumulation(tstate)
    assert tstate.acc_grads is None and tstate.mini_step == 0


def test_learning_rate_set_and_get():
    tcfg = TConfig(**NARROW)
    for accum in (1, 2):
        state = tstep.create_train_state(
            0, tcfg, tstep.make_optimizer(tcfg, accum), device="cpu")
        assert tstep.get_learning_rate(state) == tcfg.learning_rate
        tstep.set_learning_rate(state, tcfg.lr_after_drop)
        assert tstep.get_learning_rate(state) == tcfg.lr_after_drop


def test_eval_step_matches_jax():
    jcfg, jstate, _, tcfg, tstate = _pair(mr_mag_impl="fft")
    batch = _batch(4)
    want = jstep.make_eval_step(jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate.model.train()
    got = tstep.make_eval_step(tcfg)(tstate,
                                     tstep.batch_to_device(batch, "cpu"))
    assert tstate.model.training  # the eval step leaves the mode as found
    for k in ("l1", "mr", "total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.create_train_state(0, TConfig(**NARROW))


# ---- the ReLU tie: jnp.maximum(x, 0) has gradient 0.5 at an exact zero


def _unet_pair(dtype):
    jcfg = JConfig(compute_dtype=dtype, **NARROW)
    params, state = jax.jit(junet.init, static_argnums=1)(
        jax.random.key(0), jcfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    model = UNet(TConfig(compute_dtype=dtype, **NARROW))
    return jcfg, params, state, model


def _deconv5_grad_at_relu_ties(dtype):
    """Decoder levels 1-5 get zero deconv weights and biases, so their BN
    (eval mode, mean 0, var 1, bias 0) hands the ReLU exact zeros; the
    gradient of deconv5's weights then passes relu'(0), 0.5 on both sides
    (torch.clamp would give 1, torch.relu 0).  Returns (port, JAX)."""
    jcfg, params, state, model = _unet_pair(dtype)
    for p in params["dec"][:5]:
        p["w"] = np.zeros_like(p["w"])
        p["b"] = np.zeros_like(p["b"])
    model.load_state_dict(t_import.state_dict_from_jax(params, state))
    rng = np.random.default_rng(0)
    # 128 frames: the CPU's bf16 conv (oneDNN) returns garbage for the
    # width-1 bottleneck that 64 frames give
    x = rng.random((1, 512, 128)).astype(np.float32)
    r = rng.standard_normal((1, 512, 128)).astype(np.float32)

    def jloss(p):
        return jnp.sum(junet.apply(p, state, jnp.asarray(x), cfg=jcfg)[0] * r)

    want = jax.grad(jloss)(jax.tree.map(jnp.asarray, params))
    want_w5 = t_import.deconv_weight_from_hwio(np.asarray(want["dec"][4]["w"]))
    model.eval()
    (model(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
    assert np.abs(want_w5).max() > 0
    return model.deconv5.weight.grad.numpy(), want_w5


def test_relu_gradient_at_an_exact_zero_is_jaxs():
    """float32: sums in other orders only (3e-6 of the largest gradient
    observed; torch.clamp's ReLU is off by the whole of it)."""
    got_w5, want_w5 = _deconv5_grad_at_relu_ties("float32")
    np.testing.assert_allclose(got_w5, want_w5, rtol=1e-4,
                               atol=1e-5 * np.abs(want_w5).max())
    xt = torch.zeros(4, requires_grad=True)
    torch.maximum(xt, torch.zeros_like(xt)).sum().backward()
    want0 = jax.grad(lambda v: jnp.sum(jnp.maximum(v, 0.0)))(jnp.zeros(4))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want0))


def test_relu_gradient_at_an_exact_zero_is_jaxs_in_bf16():
    """bfloat16, where the ties come up in training: two bf16 conv
    backwards and no train-mode BN between the tie and deconv5's weights,
    so tests/test_torch_unet.py's bf16 bound holds (1e-2 of the largest
    gradient at most, 1e-3 median; 4.7e-3 and 0 observed).  torch.clamp's
    ReLU doubles every element here, an error of 1.0 of the largest."""
    got_w5, want_w5 = _deconv5_grad_at_relu_ties("bfloat16")
    err = np.abs(got_w5 - want_w5) / np.abs(want_w5).max()
    assert err.max() < 1e-2 and np.median(err) < 1e-3, (
        err.max(), np.median(err))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_input_gradient_matches_jax(dtype):
    """Train-mode forward (batch statistics) and backward to the input.
    f32: sums in other orders, 1e-4 of the largest gradient (6e-7
    observed).  bf16: this gradient is ill-conditioned, so any change of
    sum order or rounding point moves it by about a tenth.  Twelve layers
    of train-mode BatchNorm backward each subtract near-equal bf16 terms.
    Over weight and input seeds 0-2 on the CPU (tests/
    torch_bf16_grad_spread.py), relative L2 (median of |d| over the
    largest gradient):
    - JAX against itself, jitted (XLA's excess precision on) against op
      by op: 0.091-0.111 (6.8e-3-9.2e-3);
    - the port against itself, oneDNN convs against torch's native ones:
      0.063-0.069 (5.1e-3-5.7e-3);
    - the port against JAX op by op: 0.082-0.097 (7.2e-3-7.6e-3), and the
      same against JAX jitted with excess precision off (which then equals
      op by op), so XLA's fusion is not the cause of the gap.
    The bound, 0.25 (2.5e-2), is about twice the reference's own spread.
    No bound on this comparison can see the ReLU-tie fault: torch.clamp's
    ReLU moves the gradient by 0.017-0.026 only, inside that spread.
    test_relu_gradient_at_an_exact_zero_is_jaxs_in_bf16 catches it."""
    jcfg, params, state, model = _unet_pair(dtype)
    model.load_state_dict(t_import.state_dict_from_jax(params, state))
    rng = np.random.default_rng(1)
    x = rng.random((2, 512, 128)).astype(np.float32)
    r = rng.standard_normal((2, 512, 128)).astype(np.float32)

    def jloss(v):
        mask, _ = junet.apply(params, state, v, train=True,
                              dropout_rng=jax.random.key(0), cfg=jcfg)
        return jnp.sum(mask * r)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (model.train()(xt) * torch.from_numpy(r)).sum().backward()
    got = xt.grad.numpy()
    err = np.abs(got - want) / np.abs(want).max()
    if dtype == "float32":
        assert err.max() < 1e-4, err.max()
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 0.25 and np.median(err) < 2.5e-2, (rel, np.median(err))


def test_make_step_fn_is_train_step():
    cfg = dataclasses.replace(TConfig(**NARROW), mr_mag_impl="fft")
    state = tstep.create_train_state(3, cfg, device="cpu")
    _, a = tstep.make_step_fn(cfg)(state, tstep.batch_to_device(
        _batch(5, b=1, t=64), "cpu"))
    assert all(torch.isfinite(v) for v in a.values())

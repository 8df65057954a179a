"""The port's two-stage pipeline parallelism (``svs_torch.parallel.pp``: the
U-Net's level API, the stage split, ``shard_state`` / ``gather_state``, the
pipelined train and eval steps, ``fit`` and ``train_cli`` with ``--pp``)
with both stages on the host (``("cpu", "cpu")``), one OpenMP thread a
case.  Bounds:

- each public level (``UNet.enc_level``, ``dec_level``, ``final_dec``)
  against svs_tpu's ``make_level_fns`` / ``final_dec`` on the same weights
  and on the input svs_tpu's forward gives it, float32: atol 2e-6, except
  a train-mode activation, whose batch statistics are sums in other orders
  over up to 24,576 values: the normalised values (up to 5.6) move by up
  to 8.6e-6, so it takes the train-mode forward's 1e-5
  (tests/test_torch_unet.py);
- ``n_micro = 1`` at splits 1, 3 and 5, one SGD step at the ``default``
  preset's widths, 64 frames, float32, no dropout: the port's
  ``make_train_step``'s bits (tighter than tests/test_pp.py:119's bounds
  between svs_tpu's PP and single steps), and against svs_tpu's
  ``make_pp_train_step`` on the 8-device virtual mesh at test_pp.py:119's
  bounds for the loss (rtol 2e-6), grad_norm (rtol 2e-4) and BN running
  statistics (atol 1e-5); the parameters take the bound between the two
  packages' steps (tests/test_tp.py's, as tests/test_torch_tp.py: atol
  1e-4, rtol 1e-3), since oneDNN's conv gradients sum in other orders
  than XLA's: 4.1e-5 at most here, the same as between the two packages'
  single-device steps;
- ``n_micro = 4``, and a padded batch whose last two microbatches are
  empty: against a JAX microbatch-loop oracle built here from svs_tpu's
  ``unet.apply`` and ``combined_loss`` (tests/test_pp.py:49) at the same
  bounds, and against the port's own oracle with SGD
  (``dryrun.microbatch_oracle``) at test_pp.py's bounds for all of them
  (parameters atol 5e-6);
- with dropout 0.5 and Adam: the ``n_micro = 1`` step is
  ``make_train_step``'s bits, and the ``n_micro = 4`` step is the port's
  microbatch oracle (``dryrun.microbatch_oracle``) within the dry run's
  envelope (``dryrun.ENVELOPE``);
- a PP ``fit`` writes a ``.ckpt`` that svs_tpu's loader reads, and a PP run
  resumed from a DP run's ``.ckpt`` gives the DP run's next epoch within
  tests/test_torch_dp.py's fit bounds (train 1e-4, validation 1e-3
  relative);
- the PP train and eval steps as programs (``train/graphs.py``), routed
  through the program objects on the CPU: at 1 and 4 microbatches, a full
  batch and a ragged tail, dropout on, their eager bodies' bits; the
  one-microbatch program against svs_tpu's jitted PP step with Adam at
  learning rate 0 at the bounds above (Adam's first moment at the
  parameters' bound read as a gradient bound), the eval program against
  svs_tpu's jitted eval step; a programmed PP ``fit`` the eager one's
  bits; two distinct stage devices run the eager step.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_dp import FIT, NARROW, _lines, _one_thread, _opts, _sd, _songs
from svs_torch.cli import train_cli
from svs_torch.models import torch_import as t_import
from svs_torch.parallel import dryrun
from svs_torch.parallel import mesh as tmesh
from svs_torch.parallel import pp as tpp
from svs_torch.train import checkpoint as tck
from svs_torch.train import graphs
from svs_torch.train import loop as tloop
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.losses.mrstft import combined_loss as jloss
from svs_tpu.models import unet as junet
from svs_tpu.parallel import pp as jpp
from svs_tpu.train import checkpoint as jck
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

# the default preset's widths at 64 frames, float32 (tests/test_pp.py's)
FULL = dict(input_len=64, dropout_rate=0.0, mr_mag_impl="fft")
SGD_LR = 0.01
CPU2 = ("cpu", "cpu")


@pytest.fixture(autouse=True)
def one_thread():
    with _one_thread():
        yield


def _batch(seed=0, b=4, t=64, weight=None):
    """tests/test_pp.py's batch."""
    rng = np.random.default_rng(seed)
    mix = rng.random((b, 512, t)).astype(np.float32)
    ang = ((rng.random((b, 512, t)) - 0.5) * 6).astype(np.float32)
    out = {"mix": mix, "voc": (mix * 0.5).astype(np.float32),
           "mix_angle": ang, "voc_angle": ang}
    if weight is not None:
        out["weight"] = np.asarray(weight, np.float32)
    return out


def _sgd(model):
    return torch.optim.SGD(model.parameters(), lr=SGD_LR)


def _tstate(cfg, start, optimizer=_sgd):
    """The port's state of svs_tpu's weights ``start`` (a state dict)."""
    state = tstep.create_train_state(0, cfg, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v)
                                 for k, v in start.items()})
    if optimizer is not None:
        state.optimizer = optimizer(state.model)
    return state


def _np_sd(state):
    return {k: v.detach().numpy().copy()
            for k, v in state.model.state_dict().items()}


# tests/test_pp.py's bounds on the parameters and the BN running
# statistics, and tests/test_tp.py's on the parameters between the packages
PP_TOL = dict(params=dict(atol=5e-6, rtol=0), bn=dict(atol=1e-5, rtol=0))
JAX_TOL = dict(PP_TOL, params=dict(atol=1e-4, rtol=1e-3))


def _close(got, want, what, tol=PP_TOL):
    for k, v in want.items():
        if "num_batches" in k:
            continue
        np.testing.assert_allclose(
            got[k], v, err_msg=f"{what} {k}",
            **tol["bn" if "running" in k else "params"])


# ------------------------------------------------------------ level API


@pytest.fixture(scope="module")
def levels():
    """svs_tpu's weights and random running statistics, and the port's
    U-Net holding them."""
    jcfg = JConfig(**FULL)
    params, bn = junet.init(jax.random.key(0), jcfg)
    rng = np.random.default_rng(5)
    bn = jax.tree.map(lambda v: jnp.asarray(
        rng.uniform(0.5, 1.5, v.shape).astype(np.float32)), bn)
    model = tstep.create_train_state(0, TConfig(**FULL), device="cpu").model
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in _sd(params, bn).items()})
    return jcfg, params, bn, model


@pytest.fixture(scope="module")
def level_inputs(levels):
    """Each level's input (NHWC) in svs_tpu's forward of a batch of three
    patches, one of them padding (weight 0), in train and in eval mode:
    ``{train: (enc inputs, dec inputs, the final deconv's input)}``."""
    jcfg, params, bn, _ = levels
    weight = jnp.asarray([1.0, 0.0, 1.0])
    out = {}
    for train in (True, False):
        enc, dec = junet.make_level_fns(jcfg, train=train, weight=weight)
        x = jnp.asarray(_batch(8, 3)["mix"])[..., None]
        enc_in, dec_in, skips = [], [], []
        for i in range(6):
            enc_in.append(np.asarray(x))
            x = enc(params["enc"][i], bn["enc"][i], x)[0]
            skips.append(x)
        for i in range(5):
            inp = skips[5] if i == 0 else jnp.concatenate(
                [x, skips[5 - i]], axis=-1)
            dec_in.append(np.asarray(inp))
            x = dec(params["dec"][i], bn["dec"][i], inp, jax.random.key(0))[0]
        out[train] = (enc_in, dec_in,
                      np.asarray(jnp.concatenate([x, skips[0]], axis=-1)))
    return out


WEIGHT = np.asarray([1.0, 0.0, 1.0], np.float32)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _same_level(got, want, train):
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want[0]),
                               atol=1e-5 if train else 2e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("i", range(1, 7))
def test_enc_level_matches_svs_tpus(levels, level_inputs, i, train):
    jcfg, params, bn, model = levels
    x = level_inputs[train][0][i - 1]
    enc, _ = junet.make_level_fns(jcfg, train=train,
                                  weight=jnp.asarray(WEIGHT))
    want = enc(params["enc"][i - 1], bn["enc"][i - 1], jnp.asarray(x))
    model.train(train)
    with torch.no_grad():
        got = model.enc_level(i, _nchw(x), torch.from_numpy(WEIGHT))
    _same_level(got, want, train)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("i", range(1, 6))
def test_dec_level_matches_svs_tpus(levels, level_inputs, i, train):
    jcfg, params, bn, model = levels
    x = level_inputs[train][1][i - 1]
    _, dec = junet.make_level_fns(jcfg, train=train,
                                  weight=jnp.asarray(WEIGHT))
    # dropout 0: svs_tpu's mask keeps every channel, the port's is None
    want = dec(params["dec"][i - 1], bn["dec"][i - 1], jnp.asarray(x),
               jax.random.key(0))
    model.train(train)
    with torch.no_grad():
        got = model.dec_level(i, _nchw(x), torch.from_numpy(WEIGHT))
    _same_level(got, want, train)


def test_final_dec_matches_svs_tpus(levels, level_inputs):
    jcfg, params, _, model = levels
    x = level_inputs[True][2]
    want = junet.final_dec(params["dec"][5], jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = model.final_dec(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=2e-6)


# ------------------------------------------------------ the stage split


@pytest.mark.parametrize("split", range(1, 6))
def test_stage_of_is_svs_tpus_split(split):
    """``stage_of`` places the levels as svs_tpu's ``split_params`` cuts
    the trees, and the boundary shape is the levels' on both sides."""
    jcfg = JConfig(**FULL)
    params, _ = junet.init(jax.random.key(0), jcfg)
    s0, s1 = jpp.split_params(params, split)
    enc0 = [j + 1 for j, p in enumerate(params["enc"])
            if any(p is q for q in s0["enc"])]
    dec0 = [j + 1 for j, p in enumerate(params["dec"])
            if any(p is q for q in s0["dec"])]
    for i in range(1, 7):
        assert tpp.stage_of(f"conv{i}.0.weight", split) == (i not in enc0)
        assert tpp.stage_of(f"deconv{i}", split) == (i not in dec0)
        if i < 6:
            assert tpp.stage_of(f"deconv{i}_BAD.0.running_var", split) \
                == (i not in dec0)
    want = jpp._boundary_shape(jcfg, split, 2, 64)
    assert tpp.boundary_shape(TConfig(**FULL), split, 2, 64) == (
        want[0], want[3], want[1], want[2])


def test_state_is_placed_by_the_rule_and_a_wrong_split_is_caught():
    """Each level lives on its stage's device; stage 1 holds the fat bottom
    of the U at split 3; a step built for split 3 refuses a state cut at
    split 2 (svs_tpu's ``join_params`` check, tests/test_pp.py:275)."""
    cfg = TConfig(**FULL)
    state = tpp.shard_state(tstep.create_train_state(0, cfg, device="cpu"),
                            CPU2, split=3)
    for name, p in state.model.named_parameters():
        assert p.device == torch.device(CPU2[tpp.stage_of(name, 3)])
    b0, b1 = tpp.stage_bytes(state)
    assert b1 > 5 * b0
    assert tpp.stage_of("conv3", 3) == 0 and tpp.stage_of("conv3", 2) == 1
    wrong = tpp.shard_state(tstep.create_train_state(0, cfg, device="cpu"),
                            CPU2, split=2)
    with pytest.raises(ValueError, match="different point"):
        tpp.make_pp_train_step(CPU2, cfg, n_micro=1, split=3)(
            wrong, _batch())
    with pytest.raises(ValueError, match="split must be in 1..5"):
        tpp.stage_of("conv1", 6)
    with pytest.raises(ValueError, match="no level"):
        tpp.stage_of("final", 3)


def test_shard_and_gather_round_trip_exactly():
    """After an Adam step: ``gather_state(shard_state(s))`` holds ``s``'s
    weights, running statistics, Adam's moments and hyperparameters, bit
    for bit, on one device; the sharded state trains on."""
    cfg = TConfig(**dict(NARROW, mr_mag_impl="fft"))
    state = tstep.create_train_state(0, cfg, device="cpu")
    state, _ = tstep.make_train_step(cfg)(
        state, tstep.batch_to_device(_batch(1, 2, 128), "cpu"))
    want = tck.snapshot(state, clone=True)
    sharded = tpp.shard_state(state, CPU2, split=4)
    back = tck.snapshot(tpp.gather_state(sharded))
    assert back.state_dict.keys() == want.state_dict.keys()
    for a, b in ((back.state_dict, want.state_dict),
                 (back.exp_avg, want.exp_avg),
                 (back.exp_avg_sq, want.exp_avg_sq)):
        assert a.keys() == b.keys() and a
        for k in b:
            assert torch.equal(a[k], b[k]), k
    assert (back.adam_count, back.lr, back.betas, back.eps, back.step) == (
        want.adam_count, want.lr, want.betas, want.eps, want.step)
    # the copy is the copy: the sharded state's next step leaves it
    before = back.state_dict["conv1.0.weight"].clone()
    tpp.make_pp_train_step(CPU2, cfg, n_micro=2, split=4)(
        sharded, _batch(2, 2, 128))
    assert torch.equal(back.state_dict["conv1.0.weight"], before)
    assert not torch.equal(sharded.model.conv1[0].weight.detach(), before)


# ---------------------------------------------- the step against svs_tpu


@pytest.fixture(scope="module")
def jax_start():
    """svs_tpu's config, SGD, a maker of its start state (svs_tpu's PP step
    donates the state it is given) and that state's weights."""
    jcfg = JConfig(**FULL)
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=SGD_LR)

    def state():
        return jstep.create_train_state(jax.random.key(0), jcfg, opt)

    return jcfg, opt, state, _sd(state().params, state().bn_state)


@pytest.fixture(scope="module")
def jax_pp1(jax_start):
    """svs_tpu's n_micro = 1 PP step at splits 1, 3 and 5: the metrics and
    the gathered state dict."""
    jcfg, opt, state, _ = jax_start
    mesh = jpp.make_pp_mesh()
    out = {}
    for split in (1, 3, 5):
        step = jpp.make_pp_train_step(mesh, jcfg, opt, n_micro=1,
                                      split=split)
        new, aux = step(jpp.shard_state(state(), mesh, jcfg, split=split),
                        _batch(), jax.random.key(7))
        back = jpp.gather_state(new, jcfg, split=split)
        out[split] = ({k: float(v) for k, v in aux.items()},
                      _sd(back.params, back.bn_state))
    return out


@pytest.fixture(scope="module")
def single_sgd(jax_start):
    """The port's ``make_train_step`` with SGD from svs_tpu's weights."""
    _, _, _, start = jax_start
    cfg = TConfig(**FULL)
    with _one_thread():
        state, m = tstep.make_train_step(cfg)(
            _tstate(cfg, start), tstep.batch_to_device(_batch(), "cpu"))
    return {k: float(v) for k, v in m.items()}, _np_sd(state)


@pytest.mark.parametrize("split", [1, 3, 5])
def test_one_microbatch_is_svs_tpus_pp_step_and_the_single_step(
        jax_start, jax_pp1, single_sgd, split):
    _, _, _, start = jax_start
    cfg = TConfig(**FULL)
    state = tpp.shard_state(_tstate(cfg, start), CPU2, split=split)
    state, m = tpp.make_pp_train_step(CPU2, cfg, n_micro=1, split=split)(
        state, _batch(), torch.Generator().manual_seed(1))
    got = {k: float(v) for k, v in m.items()}
    sd = _np_sd(state)
    want_m, want_sd = jax_pp1[split]
    np.testing.assert_allclose(got["total"], want_m["total"], rtol=2e-6)
    np.testing.assert_allclose(got["grad_norm"], want_m["grad_norm"],
                               rtol=2e-4)
    _close(sd, want_sd, f"svs_tpu split {split}", JAX_TOL)
    single_m, single_sd = single_sgd
    assert got == single_m
    for k, v in single_sd.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)


def _jax_oracle(state, batch, cfg, n_micro, opt, key):
    """tests/test_pp.py:49's microbatch loop: contiguous microbatches, the
    BN state threaded in order, the mean gradient, one update; empty
    microbatches skipped."""

    @jax.jit
    def grad(params, bn, mb):
        def loss_fn(p):
            mask, new_bn = junet.apply(p, bn, mb["mix"], train=True,
                                       dropout_rng=key, cfg=cfg,
                                       weight=mb.get("weight"))
            total, aux = jloss(mask, mb["mix"], mb["voc"], mb["mix_angle"],
                               mb["voc_angle"], cfg, weight=mb.get("weight"))
            return total, (new_bn, aux)
        return jax.grad(loss_fn, has_aux=True)(params)

    rows = len(batch["mix"]) // n_micro
    bn, grads, losses = state.bn_state, None, []
    for m in range(n_micro):
        sl = {k: jnp.asarray(v[m * rows:(m + 1) * rows])
              for k, v in batch.items()}
        if "weight" in sl and float(jnp.sum(sl["weight"])) == 0.0:
            continue
        g, (bn, aux) = grad(state.params, bn, sl)
        losses.append(float(aux["total"]))
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    grads = jax.tree.map(lambda x: x / len(losses), grads)
    updates, _ = opt.update(grads, state.opt_state, state.params)
    return optax.apply_updates(state.params, updates), bn, \
        float(np.mean(losses))


@pytest.mark.parametrize("weight", [None, [1, 1, 0, 0]],
                         ids=["full", "two_empty_microbatches"])
def test_four_microbatches_are_the_jax_microbatch_oracle(jax_start, weight):
    """GPipe semantics: per-microbatch BatchNorm statistics, the running
    statistics in microbatch order, the mean gradient; a padded batch's
    empty microbatches are skipped and everything stays finite."""
    jcfg, opt, state, start = jax_start
    batch = _batch(3, weight=weight)
    if weight is not None:
        for k in ("mix", "voc"):
            batch[k][2:] = 0.0
    params, bn, loss = _jax_oracle(state(), batch, jcfg, 4, opt,
                                   jax.random.key(3))
    cfg = TConfig(**FULL)
    pstate = tpp.shard_state(_tstate(cfg, start), CPU2, split=3)
    pstate, m = tpp.make_pp_train_step(CPU2, cfg, n_micro=4, split=3)(
        pstate, batch, torch.Generator().manual_seed(3))
    assert all(np.isfinite(float(v)) for v in m.values())
    np.testing.assert_allclose(float(m["total"]), loss, rtol=2e-6)
    _close(_np_sd(pstate), _sd(params, bn), "svs_tpu's oracle", JAX_TOL)
    ostate, om = dryrun.microbatch_oracle(
        _tstate(cfg, start), batch, torch.Generator().manual_seed(3), cfg, 4)
    np.testing.assert_allclose(float(m["total"]), float(om["total"]),
                               rtol=2e-6)
    _close(_np_sd(pstate), _np_sd(ostate), "the port's oracle")


# ------------------------------------------------- the port's own steps


@pytest.mark.parametrize("impl", ["fft", "pallas_bf16", "pallas_fused"])
def test_one_microbatch_with_dropout_is_make_train_steps_bits(impl):
    """Adam, dropout 0.5, the narrow U-Net at 128 frames: the masks come
    from the step's generator in ``UNet.forward``'s order, so the step is
    ``make_train_step``'s bits (the loss kernels' plain versions here)."""
    cfg = TConfig(**dict(NARROW, mr_mag_impl=impl, dropout_rate=0.5))
    r = dryrun.pp_parity(CPU2, cfg, _batch(4, 4, 128), n_micro=1, split=2)
    assert r["ok"] and r["bits"] == 0.0, r


@pytest.mark.parametrize("weight", [None, [1, 1, 1, 1, 1, 1, 0, 0]],
                         ids=["full", "empty_last_microbatch"])
def test_four_microbatches_with_dropout_are_the_ports_oracle(weight):
    """Adam, dropout 0.5, bf16 convs: each microbatch draws its masks from
    its own generator (``pp.microbatch_generators``); within the dry
    run's envelope of ``dryrun.microbatch_oracle``, the loss and the BN
    running statistics the oracle's bits."""
    cfg = TConfig(**dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5,
                         compute_dtype="bfloat16"))
    batch = _batch(5, 8, 128, weight=weight)
    r = dryrun.pp_parity(CPU2, cfg, batch, n_micro=4, split=3)
    assert r["ok"] and r["loss_rel"] == 0.0 and r["bn_abs"] == 0.0, r


def test_each_tick_enqueues_its_copies_after_both_stages_work(monkeypatch):
    """A copy between two cards orders both cards' streams, so each tick
    enqueues stage 0's A and C and stage 1's B before its copies: the
    boundary tensors and stage 1's three Dropout2d masks of the microbatch
    that A produced (split 3, two microbatches, train mode)."""
    cfg = TConfig(**dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5))
    model = tpp.shard_state(tstep.create_train_state(0, cfg, device="cpu"),
                            CPU2, split=3).model.train()
    log = []
    for name in ("encode", "decode"):
        def level(i, *a, _f=getattr(model, name), _n=name[:3], **kw):
            log.append(f"{_n}{i}")
            return _f(i, *a, **kw)
        monkeypatch.setattr(model, name, level)
    final = model.final_dec
    monkeypatch.setattr(model, "final_dec",
                        lambda x: log.append("final") or final(x))
    to = torch.Tensor.to

    def copy(self, *a, **kw):
        if kw.get("non_blocking"):
            log.append("copy")
        return to(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", copy)
    tpp.make_pp_pipeline(CPU2, cfg, n_micro=2, split=3)(
        model, _batch(2, 2, 128), torch.Generator().manual_seed(0))
    a = ["enc1", "enc2", "enc3"]
    b = ["enc4", "enc5", "enc6", "dec1", "dec2", "dec3"]
    c = ["dec4", "dec5", "final"]
    assert log == (a + ["copy"] * 4 + a + b + ["copy"] * 5 + b + c
                   + ["copy"] + c)


def test_microbatch_generators_fold_in_the_index():
    """One generator a microbatch, a function of the step generator's state
    and the index; the step generator advances, so the next step draws
    other masks; one microbatch keeps the step's generator."""
    g = torch.Generator().manual_seed(9)
    first = [torch.rand(4, generator=x)
             for x in tpp.microbatch_generators(g, 3)]
    second = [torch.rand(4, generator=x)
              for x in tpp.microbatch_generators(g, 3)]
    again = [torch.rand(4, generator=x) for x in tpp.microbatch_generators(
        torch.Generator().manual_seed(9), 3)]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not any(torch.equal(a, b) for a, b in zip(first, second))
    assert not torch.equal(first[0], first[1])
    assert tpp.microbatch_generators(g, 1) == [g]


def test_eval_step_is_make_eval_steps():
    cfg = TConfig(**dict(NARROW, mr_mag_impl="fft"))
    state = tstep.create_train_state(0, cfg, device="cpu")
    batch = tpp.pad_batch({k: v[:3] for k, v in _batch(6, 4, 128).items()},
                          4)
    want = tstep.make_eval_step(cfg)(state,
                                     tstep.batch_to_device(batch, "cpu"))
    state = tpp.shard_state(state, CPU2, split=1)
    got = tpp.make_pp_eval_step(CPU2, cfg, split=1)(state, batch)
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}


def test_pad_batch_is_svs_tpus():
    host = {k: v[:3] for k, v in _batch(7, 4, 64).items()}
    want = jpp.pad_batch(host, 4)
    for got in (tpp.pad_batch(host, 4), tpp.pad_batch(
            {k: torch.from_numpy(v) for k, v in host.items()}, 4)):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    full = _batch(7, 4, 64)
    assert tpp.pad_batch(full, 4) is full
    with pytest.raises(ValueError, match="> batch_size"):
        tpp.pad_batch(full, 3)


# ---------------------------------------------------------- refusals


def test_refusals(monkeypatch, tmp_path):
    cfg = TConfig(**dict(NARROW, mr_mag_impl="fft"))
    # accumulation (svs_tpu's _check_opt)
    state = tstep.create_train_state(
        0, cfg, tstep.make_optimizer(cfg, accum_steps=2), device="cpu")
    with pytest.raises(ValueError, match="accum"):
        tpp.shard_state(state, CPU2)
    # n_micro must divide the batch
    state = tpp.shard_state(tstep.create_train_state(0, cfg, device="cpu"),
                            CPU2)
    with pytest.raises(ValueError, match="must divide"):
        tpp.make_pp_train_step(CPU2, cfg, n_micro=3)(state, _batch(0, 4,
                                                                    128))
    with pytest.raises(ValueError, match="no live row"):
        tpp.make_pp_train_step(CPU2, cfg, n_micro=2)(
            state, _batch(0, 4, 128, weight=[0, 0, 0, 0]))
    with pytest.raises(ValueError, match="pair of stage devices"):
        tpp.stage_devices(("cpu",))
    # without two cards, no fallback to the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="pipeline needs 2 devices, have 1"):
        tpp.make_pp_mesh()


def test_mesh_notices_idle_devices(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert tpp.make_pp_mesh() == (torch.device("cuda", 0),
                                  torch.device("cuda", 1))
    assert "the other 6 stay idle" in capsys.readouterr().out


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    return _songs(str(tmp_path_factory.mktemp("pp_songs")))


def _pp_opts(songs, out, **kw):
    return tloop.TrainOptions(**_opts(songs, out, **dict(
        dict(mesh=CPU2, parallel="pp", pp_micro=3, device="cpu"), **kw)))


@pytest.mark.parametrize("kw,says", [
    (dict(accum_steps=2), "accum"), (dict(pp_micro=2), "must divide"),
    (dict(pp_split=0), "split must be in 1..5"),
    (dict(epoch_scan=True), "not cp/tp/zero1/fsdp"),
    (dict(zero1=True), "dp only"), (dict(mesh=None), "make_pp_mesh"),
    (dict(mesh=("cpu", "cpu", "cpu")), "pair of stage devices")])
def test_fit_refuses_what_svs_tpus_refuses(songs, tmp_path, kw, says):
    with pytest.raises(ValueError, match=says):
        tloop.fit(_pp_opts(songs, str(tmp_path), **kw),
                  TConfig(**FIT))


def test_fit_refuses_a_multi_process_run(songs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="single-process"):
        tloop.fit(_pp_opts(songs, str(tmp_path)), TConfig(**FIT))


# ------------------------------------------------------------------ fit


@pytest.fixture(scope="module")
def dp_fits(songs, tmp_path_factory):
    """Two epochs, and the first alone, of a DP fit on a world of one (a
    gloo group in this process, destroyed after)."""
    out = {}
    with _one_thread():
        mesh = tmesh.make_mesh(device="cpu")
        try:
            for epoch in (1, 2):
                out[epoch] = str(tmp_path_factory.mktemp(f"dp{epoch}"))
                tloop.fit(tloop.TrainOptions(**_opts(
                    songs, out[epoch], epoch=epoch, mesh=mesh,
                    device="cpu")), TConfig(**FIT))
        finally:
            torch.distributed.destroy_process_group()
    return out


def _fit_bounds(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.startswith("Val ") == b.startswith("Val ")
        np.testing.assert_allclose(float(a.split()[-1]), float(b.split()[-1]),
                                   rtol=1e-3 if a.startswith("Val ")
                                   else 1e-4)


def test_fit_writes_a_ckpt_svs_tpu_loads_and_resumes_a_dp_run(
        songs, dp_fits, tmp_path):
    """One PP epoch (batch 3 in 3 microbatches, 4 patches: a full batch and
    a tail padded to 3 rows, two of its microbatches empty) writes a
    ``.ckpt`` that svs_tpu loads into the PP state's weights; a PP run at
    one microbatch resumed from the DP run's first-epoch ``.ckpt`` logs
    the DP run's second epoch."""
    out = str(tmp_path / "pp")
    state = tloop.fit(_pp_opts(songs, out, epoch=1), TConfig(**FIT))
    assert isinstance(state, tpp.PPState) and state.step == 2
    assert sorted(os.listdir(os.path.join(out, "CKPT"))) == [
        "svs_best_t.ckpt", "svs_t.ckpt"]
    lines = _lines(out, "log_t.txt")
    assert len(lines) == 2 and lines[1].startswith("Val ")
    assert all(np.isfinite(float(x.split()[-1])) for x in lines)
    jstate, epoch, _ = jck.load(os.path.join(out, "CKPT", "svs_t.ckpt"),
                                jstep.create_train_state(jax.random.key(0),
                                                         JConfig(**FIT)))
    assert epoch == 1 and int(jstate.step) == 2
    loaded = _sd(jstate.params, jstate.bn_state)
    for k, v in _np_sd(state).items():
        if "num_batches" not in k:
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)

    resumed = str(tmp_path / "resumed")
    state = tloop.fit(_pp_opts(
        songs, resumed, pp_micro=1, pp_split=2,
        load_path=os.path.join(dp_fits[1], "CKPT", "svs_t.ckpt")),
        TConfig(**FIT))
    assert state.step == 4
    _fit_bounds(_lines(resumed, "log_t.txt"),
                _lines(dp_fits[2], "log_t.txt")[2:])
    # and the single-device fit resumes from the PP run's checkpoint
    single = tloop.fit(tloop.TrainOptions(**_opts(
        songs, str(tmp_path / "single"), epoch=3, device="cpu",
        load_path=os.path.join(resumed, "CKPT", "svs_t.ckpt"))),
        TConfig(**FIT))
    assert single.step == 6


def test_train_cli_pp_on_the_cpu(songs, tmp_path, capsys):
    """``train_cli --pp --device cpu``: one epoch with validation, then a
    resume at another split from its ``.ckpt``."""
    common = ["--label", "c", "--train_folder", songs, "--valid_folder",
              songs, "--val_interval", "1", "--batch_size", "4",
              "--samples_per_song", "2", "--dtype", "float32", "--ckpt_dir",
              str(tmp_path / "CKPT"), "--log_dir", str(tmp_path / "LOG"),
              "--device", "cpu", "--pp", "--pp_micro", "2"]
    assert train_cli.main(common + ["--load_path", str(tmp_path / "no"),
                                    "--epoch", "1"]) == 0
    assert train_cli.main(common + ["--load_path",
                                    str(tmp_path / "CKPT" / "svs_c.ckpt"),
                                    "--epoch", "2", "--pp_split", "5"]) == 0
    said = capsys.readouterr().out
    assert "Pipeline-parallel over 2 stages on cpu and cpu" in said
    lines = _lines(str(tmp_path), "log_c.txt")
    assert len(lines) == 4 and lines[1].startswith("Val ")
    assert all(np.isfinite(float(x.split()[-1])) for x in lines)


@pytest.mark.parametrize("argv,says", [
    (["--pp", "--dp"], "mutually exclusive"),
    (["--pp", "--tp", "2"], "mutually exclusive"),
    (["--pp", "--cp"], "mutually exclusive"),
    (["--pp", "--accum", "2"], "does not compose with --accum"),
    (["--pp", "--epoch_scan"], "not cp/tp/zero1/fsdp"),
    (["--pp", "--device", "cuda"], "pipeline needs 2 devices")])
def test_train_cli_pp_refuses_what_svs_tpus_refuses(argv, says, capsys):
    with pytest.raises(SystemExit) as err:
        train_cli.main(["--label", "x", "--device", "cpu", *argv])
    assert err.value.code == 2
    said = capsys.readouterr().err
    assert says in said and "not ported" not in said


# ------------------------------------------------------- the programs


@pytest.fixture
def routed(monkeypatch):
    """PP's steps through the program objects of ``train/graphs.py`` on
    the CPU (whose steps are eager otherwise), in a fresh cache: the
    key, the binding, the warm-up step, the static buffers, the copies
    in and out and the re-seeded generators run as on a card."""
    cache = graphs.infer_graphs.ProgramCache(graphs.MAX_BYTES)
    monkeypatch.setattr(graphs, "programmed", lambda dev: True)
    monkeypatch.setattr(graphs, "CACHE", cache)
    return cache


def _snap(state):
    """The state's parameters and buffers and Adam's moments by name, and
    its counts."""
    snap = tck.snapshot(state, clone=True)
    return ({k: v.numpy() for k, v in snap.state_dict.items()},
            {k: v.numpy() for k, v in snap.exp_avg.items()},
            {k: v.numpy() for k, v in snap.exp_avg_sq.items()},
            (snap.adam_count, snap.step))


def _same_bits(got, want, what):
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")


def _program_calls(n_micro):
    """Five calls alternating a full batch of 4 and a tail of 3 padded to
    4 (``pad_batch``: at 4 microbatches its last one is empty), and the
    eval batches: the full one and the padded tail."""
    full = _batch(11, 4, 128)
    tail = tpp.pad_batch({k: v[:3] for k, v in _batch(12, 4, 128).items()},
                         4)
    return [full, tail, full, tail, full], [full, tail]


def _run_forms(cfg, n_micro, devs=CPU2, split=3, n_calls=5):
    """The PP step and eval step over the first ``n_calls`` of
    ``_program_calls`` (and a call with another generator) from the state
    of seed 0 with a generator of seed 1, as programs (where the rule
    takes them) and eagerly (``step.eager``): per form the metrics, the
    evals, :func:`_snap` and the generator's state after; and the
    programmed state's model."""
    calls, evals = _program_calls(n_micro)
    calls = calls[:n_calls]
    out, models = {}, {}
    for form in ("program", "eager"):
        state = tpp.shard_state(tstep.create_train_state(0, cfg,
                                                         device="cpu"),
                                devs, split=split)
        step = tpp.make_pp_train_step(devs, cfg, n_micro=n_micro,
                                      split=split)
        evaluate = tpp.make_pp_eval_step(devs, cfg, split=split)
        if form == "eager":
            step, evaluate = step.eager, evaluate.eager
        gen = torch.Generator().manual_seed(1)
        metrics = [{k: v.numpy().copy() for k, v in step(state, b, gen)[
            1].items()} for b in calls]
        # another generator: the full batch's program captures again
        gen = torch.Generator().manual_seed(2)
        metrics.append({k: v.numpy().copy() for k, v in step(
            state, calls[0], gen)[1].items()})
        ev = [{k: v.numpy().copy() for k, v in evaluate(state, b).items()}
              for b in evals]
        out[form] = (metrics, ev, _snap(state), gen.get_state())
        models[form] = state.model
    return out, models["program"]


@pytest.mark.parametrize("n_micro", [1, 4])
def test_pp_programs_are_their_eager_bodies_bits(routed, n_micro):
    """Adam, dropout 0.5: the programs of a full batch and of a ragged
    tail (a live pattern each) leave the eager body's metrics, parameters,
    BN, Adam's moments and counts, bit for bit, and the generator where
    the eager step leaves it; each train program is a warm-up step, a
    capture and replays, reused on every call of its key, and captured
    again for another generator; the eval programs give the eager eval's
    bits."""
    cfg = TConfig(**dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5))
    out, model = _run_forms(cfg, n_micro)
    (pm, pe, ps, pg), (em, ee, es, eg) = out["program"], out["eager"]
    for i, (a, b) in enumerate(zip(pm + pe, em + ee)):
        _same_bits(a, b, f"call {i}")
    for part, (a, b) in enumerate(zip(ps[:3], es[:3])):
        _same_bits(a, b, f"state part {part}")
    assert ps[3] == es[3] == (6, 6)
    assert torch.equal(pg, eg)
    progs = routed.programs_of(model)
    train = [p for p in progs if hasattr(p, "captures")]
    assert sorted((p.captures, p.replays) for p in train) == [(1, 1), (2, 3)]
    assert len(progs) == 4 and routed.builds == 4  # two train, two eval
    live = sorted(k[-1] for k in routed._programs if k[0] == "train")
    assert live == sorted([(n_micro, 3, (True,) * n_micro, n_micro > 1),
                           (n_micro, 3, (True,) * (n_micro - 1)
                            + ((n_micro == 1),), n_micro > 1)])


def test_two_pp_steps_over_one_model_share_their_programs(routed):
    """Two ``make_pp_train_step`` over one model at 4 microbatches,
    dropout 0.5, called in turns with one generator: they share the
    programs of their keys (the step holds no generator of its own; a
    program seeds its own from each call's generator), and every call
    gives the eager steps' bits, the state and the generator too."""
    cfg = TConfig(**dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5))
    calls, _ = _program_calls(4)
    out = {}
    for form in ("program", "eager"):
        state = tpp.shard_state(tstep.create_train_state(0, cfg,
                                                         device="cpu"),
                                CPU2)
        steps = [tpp.make_pp_train_step(CPU2, cfg, n_micro=4)
                 for _ in range(2)]
        if form == "eager":
            steps = [s.eager for s in steps]
        gen = torch.Generator().manual_seed(1)
        metrics = [{k: v.numpy().copy() for k, v in steps[i % 2](
            state, b, gen)[1].items()} for i, b in enumerate(calls)]
        out[form] = (metrics, _snap(state), gen.get_state())
    (pm, ps, pg), (em, es, eg) = out["program"], out["eager"]
    for i, (a, b) in enumerate(zip(pm, em)):
        _same_bits(a, b, f"call {i}")
    for part, (a, b) in enumerate(zip(ps[:3], es[:3])):
        _same_bits(a, b, f"state part {part}")
    assert ps[3] == es[3] == (5, 5) and torch.equal(pg, eg)
    assert routed.builds == 2  # a full batch's program and a tail's


def test_pp_over_two_distinct_devices_runs_the_eager_step(routed):
    """The rule (``pp.programmed``): programs where both stages are one
    device; two distinct devices (here the host as ``cpu`` and ``cpu:0``)
    run the eager step, decided before any step: no program is built, and
    the step is the eager body's bits."""
    two = ("cpu", "cpu:0")
    assert tpp.programmed(CPU2) and not tpp.programmed(two)
    assert not graphs.stages_programmed((torch.device("cuda", 0),
                                         torch.device("cuda", 1)))
    cfg = TConfig(**dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5))
    out, _ = _run_forms(cfg, 2, devs=two, n_calls=2)
    assert routed.builds == 0
    (pm, pe, ps, _), (em, ee, es, _) = out["program"], out["eager"]
    for i, (a, b) in enumerate(zip(pm + pe, em + ee)):
        _same_bits(a, b, f"call {i}")
    for part, (a, b) in enumerate(zip(ps[:3], es[:3])):
        _same_bits(a, b, f"state part {part}")


def test_pp_program_refuses_a_batch_with_no_live_row_before_it_runs(
        routed):
    cfg = TConfig(**dict(NARROW, mr_mag_impl="fft"))
    state = tpp.shard_state(tstep.create_train_state(0, cfg, device="cpu"),
                            CPU2)
    for run in (tpp.make_pp_train_step(CPU2, cfg, n_micro=2),
                lambda s, b: tpp.make_pp_eval_step(CPU2, cfg)(s, b)):
        with pytest.raises(ValueError, match="no live row"):
            run(state, _batch(0, 4, 128, weight=[0, 0, 0, 0]))
    assert routed.builds == 0 and state.step == 0


@pytest.fixture(scope="module")
def jax_adam_pp(jax_start):
    """svs_tpu's n_micro = 1 PP step at split 3 with Adam at learning rate
    0 (every call starts from the same parameters) over two calls: after
    each the metrics, the BN running statistics and Adam's first moment
    by the port's names."""
    jcfg, _, state, start = jax_start
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=0.0)
    mesh = jpp.make_pp_mesh()
    step = jpp.make_pp_train_step(mesh, jcfg, opt, n_micro=1, split=3)
    st = jpp.shard_state(jstep.create_train_state(jax.random.key(0), jcfg,
                                                  opt), mesh, jcfg, split=3)
    out = []
    for batch in (_batch(), _batch(3)):
        st, aux = step(st, batch, jax.random.key(7))
        back = jpp.gather_state(st, jcfg, split=3)
        sd = _sd(back.params, back.bn_state)
        mu = _sd(back.opt_state.inner_state[0].mu, back.bn_state)
        out.append(({k: float(v) for k, v in aux.items()},
                    {k: v for k, v in sd.items() if "running" in k},
                    {k: mu[k] for k in start if "running" not in k
                     and "num_batches" not in k}))
    return out


def test_pp_program_matches_svs_tpus_jitted_pp_step(routed, jax_start,
                                                    jax_adam_pp):
    """The one-microbatch program (its first call the eager warm-up, its
    second a replay) from svs_tpu's weights, Adam at learning rate 0, no
    dropout: after each call the loss (rtol 2e-6), ``grad_norm`` (rtol
    2e-4), the BN running statistics (atol 1e-5) and Adam's first moment
    are svs_tpu's PP step's; then the eval program against svs_tpu's
    jitted eval step (the loss's rtol 2e-6).  The first moment takes the
    parameters' bound between the packages (atol 1e-4, rtol 1e-3 after an
    SGD step of ``SGD_LR``) as a bound on the gradient, atol 1e-4 /
    ``SGD_LR``: after the first call the moment is 0.1 of one gradient
    (atol 1e-3), after the second 0.1 of one and 0.09 of the other (atol
    1.9e-3)."""
    _, _, _, start = jax_start
    cfg = TConfig(**FULL)
    state = _tstate(cfg, start, optimizer=None)
    tstep.set_learning_rate(state, 0.0)
    state = tpp.shard_state(state, CPU2, split=3)
    step = tpp.make_pp_train_step(CPU2, cfg, n_micro=1, split=3)
    grad_atol = 1e-4 / SGD_LR
    for batch, (want_m, want_bn, want_mu), share in zip(
            (_batch(), _batch(3)), jax_adam_pp, (0.1, 0.1 + 0.09)):
        state, m = step(state, batch, torch.Generator().manual_seed(1))
        np.testing.assert_allclose(float(m["total"]), want_m["total"],
                                   rtol=2e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   want_m["grad_norm"], rtol=2e-4)
        sd, mu, _, _ = _snap(state)
        for k, v in want_bn.items():
            np.testing.assert_allclose(sd[k], v, atol=1e-5, rtol=0,
                                       err_msg=k)
        for k, v in want_mu.items():
            np.testing.assert_allclose(mu[k], v, atol=share * grad_atol,
                                       rtol=1e-3, err_msg=k)
    train = [p for p in routed.programs_of(state.model)
             if hasattr(p, "captures")]
    assert [(p.captures, p.replays) for p in train] == [(1, 1)]

    jcfg = JConfig(**FULL)
    jst = jstep.create_train_state(jax.random.key(0), jcfg)
    want = jstep.make_eval_step(jcfg)(jst, {k: jnp.asarray(v) for k, v in
                                            _batch(9).items()})
    fresh = tpp.shard_state(_tstate(cfg, start, optimizer=None), CPU2,
                            split=3)
    got = tpp.make_pp_eval_step(CPU2, cfg, split=3)(fresh, _batch(9))
    for k in ("l1", "mr", "total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-6,
                                   err_msg=k)


def test_programmed_pp_fit_is_the_eager_fit(routed, songs, tmp_path,
                                            monkeypatch):
    """One epoch of ``fit(parallel='pp')`` with validation (batch 3 in 3
    microbatches: a full batch and a tail padded to 3 rows, two of its
    microbatches empty) through the programs: the eager fit's log and
    final state, bit for bit."""
    runs = {}
    for form in ("programs", "eager"):
        if form == "eager":
            monkeypatch.setattr(graphs, "programmed", lambda dev: False)
        out = str(tmp_path / form)
        state = tloop.fit(_pp_opts(songs, out, epoch=1), TConfig(**FIT))
        runs[form] = (_lines(out, "log_t.txt"), _snap(state))
    (pl, ps), (el, es) = runs["programs"], runs["eager"]
    assert pl == el and len(pl) == 2
    for part, (a, b) in enumerate(zip(ps[:3], es[:3])):
        _same_bits(a, b, f"state part {part}")
    assert ps[3] == es[3]
    assert routed.builds >= 3  # the full batch's, the tail's, an eval's

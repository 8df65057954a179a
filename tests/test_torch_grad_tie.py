"""The port's float32 single-device gradient against svs_tpu's, and the
near-tie that parts them on one draw (ROADMAP C.8).

The narrow U-Net of ``tests/test_torch_dp.py`` (``enc_channels=(4, 8, 8,
16, 16, 16)``, dropout 0, 128 frames, ``mr_mag_impl='fft'``, float32), its
weights ``svs_tpu.train.step.create_train_state(jax.random.key(s), ...)``
carried over by ``torch_import.state_dict_from_jax``, the batch
``_batch(s, 3)``.  svs_tpu's gradient is read from its jitted step's
``opt_state`` (``_GRAB``); the port's is ``step.loss_and_grads`` on the CPU.

On draws 10, 11 and 13 the two part by 2.4e-6 to 2.6e-6 relative L2 over
all parameter gradients, under ``tests/test_torch_dp.py``'s 1e-5.  On draw
12 they part by 9.75e-4, and svs_tpu parts from itself as much:

- The level-by-level VJPs agree.  Given the port's activations and output
  cotangent, ``jax.vjp`` of each of svs_tpu's 12 levels gives the port's
  input cotangent to 2e-7..4e-7 and its weight gradient to 1.6e-7..2.8e-6.
  The cotangent entering decoder level 5 agrees to 1.2e-6.  The one leaving
  it (decoder level 4's output) parts by 3.4e-3, all of it in example 2
  around row 20, column 17.
- The cause is one element.  Deconv 5's BatchNorm output at example 2,
  channel 3, row 40, column 34 lies within the forward's rounding of 0:
  the port's is +4.44e-7.  svs_tpu's level-by-level forwards give
  -3.23e-7 (jitted), -5.25e-7 (eager), -5.66e-7 (weighted) and +2.42e-7
  (packed edge convs).  Two float32 forwards part there by ~1e-6 (4-6e-6
  at the level's input).  The ReLU after it lets that element's cotangent
  through on one side of 0 and not on the other, and the gradient of every
  level below moves with it.
- svs_tpu's own rewrites show the same move.  Its ``packed_edge_convs``
  lowering (an exact rewrite, ``svs_tpu/models/unet.py:80-91``) gives a
  gradient 9.75e-4 from its default jitted step's when the U-Net runs op
  by op, un-jitted, as ``make_step_fn`` runs it without ``jax.jit``.  It
  gives 2.3e-6 under ``jax.jit``.  The port lies within 1.7e-6 of that
  un-jitted packed gradient.  svs_tpu's other forms (eager, remat,
  weighted, DP on 2 and 3 devices) stay within 2.7e-6 of its default.

So on this draw the gradient is decided by which side of 0 one activation
rounds to.  That is a near-tie of the float32 model, not a fault of the
port's backward.  The test checks that claim.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp
import optax

from svs_torch.models import torch_import as t_import
from svs_torch.models.unet import batch_norm
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.losses.mrstft import combined_loss as j_combined_loss
from svs_tpu.models import unet as junet
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), dropout_rate=0.0,
              input_len=128, mr_mag_impl="fft")
BOUND = 1e-5  # tests/test_torch_dp.py's gradient bound, relative L2
TIE_DRAW = 12
# deconv 5's BatchNorm output at the tie: (example, channel, row, column)
TIE = (2, 3, 40, 34)

# the gradient's optimiser: no update, and the state is the gradient
_GRAB = optax.GradientTransformation(
    lambda p: p, lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(autouse=True)
def one_thread():
    with threadpoolctl.threadpool_limits(1, user_api="openmp"):
        yield


@pytest.fixture(scope="module")
def jitted_step():
    return jax.jit(jstep.make_step_fn(JConfig(**NARROW), _GRAB))


def _batch(seed, b, t=128):
    rng = np.random.default_rng(seed)
    mix = rng.random((b, 512, t)).astype(np.float32)
    return {"mix": mix,
            "voc": (mix * rng.random((b, 512, t))).astype(np.float32),
            "mix_angle": rng.uniform(-np.pi, np.pi, (b, 512, t)
                                     ).astype(np.float32),
            "voc_angle": rng.uniform(-np.pi, np.pi, (b, 512, t)
                                     ).astype(np.float32)}


def _sd(params, bn_state):
    return {k: v.numpy() for k, v in t_import.state_dict_from_jax(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, bn_state)).items()}


def _svs_tpu(seed, jitted_step):
    """The draw's state (svs_tpu's pytrees and the port's state dict), its
    batch, and svs_tpu's jitted gradient by state-dict name."""
    state = jstep.create_train_state(jax.random.key(seed), JConfig(**NARROW),
                                     _GRAB)
    start = _sd(state.params, state.bn_state)  # the step donates the state
    batch = _batch(seed, 3)
    out, _ = jitted_step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.key(1))
    return (jstep.create_train_state(jax.random.key(seed), JConfig(**NARROW),
                                     _GRAB),
            start, batch, _sd(out.opt_state, out.bn_state))


def _port(start, batch):
    cfg = TConfig(**NARROW)
    state = tstep.create_train_state(0, cfg, device="cpu")
    state.model.load_state_dict({k: torch.as_tensor(v)
                                 for k, v in start.items()})
    grads, _ = tstep.loss_and_grads(
        cfg, state, {k: torch.as_tensor(v) for k, v in batch.items()},
        torch.Generator().manual_seed(1))
    names = [n for n, _ in state.model.named_parameters()]
    return state.model, dict(zip(names, (g.numpy() for g in grads)))


def _rel(got, want):
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in got)
    den = sum(float((want[k] ** 2).sum()) for k in got)
    return np.sqrt(num / den)


@pytest.mark.parametrize("seed", [10, 11, 13])
def test_single_device_gradient_matches_svs_tpus_jitted_step(jitted_step,
                                                             seed):
    _, start, batch, want = _svs_tpu(seed, jitted_step)
    _, got = _port(start, batch)
    assert _rel(got, want) <= BOUND


def test_float32_gradient_near_tie_moves_svs_tpu_as_much(jitted_step):
    """The module's claim on draw 12: svs_tpu's gradient moves by about
    1e-3 between two of its own forms, the port lies within the bound of
    one of them, and one activation lies within 1e-6 of a ReLU's gate."""
    state, start, batch, jitted = _svs_tpu(TIE_DRAW, jitted_step)
    model, got = _port(start, batch)

    # svs_tpu's U-Net op by op with its packed edge convs, and the
    # gradient of its loss in the mask, jitted
    cfg = JConfig(**dict(NARROW, packed_edge_convs=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_grad = jax.jit(jax.grad(lambda mask: j_combined_loss(
        mask, jb["mix"], jb["voc"], jb["mix_angle"], jb["voc_angle"],
        JConfig(**NARROW))[0]))
    mask, vjp = jax.vjp(lambda p: junet.apply(
        p, state.bn_state, jb["mix"], train=True,
        dropout_rng=jax.random.key(1), cfg=cfg)[0], state.params)
    packed, = vjp(loss_grad(mask))
    packed = {k: v for k, v in _sd(packed, state.bn_state).items()
              if k in got}

    own = _rel(packed, jitted)
    assert own > 5e-4, f"svs_tpu's two forms part by only {own:.2e}"
    assert min(_rel(got, jitted), _rel(got, packed)) <= BOUND

    # the port's deconv 5 BatchNorm output: its smallest |x| is the tie
    with torch.no_grad():
        x = torch.from_numpy(batch["mix"])[:, None]
        skips = []
        for i in range(1, 7):
            x = model.enc_level(i, x)[0]
            skips.append(x)
        for i in range(1, 5):
            inp = skips[5] if i == 1 else torch.cat([x, skips[6 - i]], 1)
            x = model.dec_level(i, inp)[0]
        bn = model.deconv5_BAD[0]
        y, _, _ = batch_norm(
            model.deconv(5, torch.cat([x, skips[1]], 1)), bn.weight, bn.bias,
            bn.running_mean, bn.running_var, train=True, eps=bn.eps,
            momentum=bn.momentum)
    y = y.abs().numpy()
    assert np.unravel_index(y.argmin(), y.shape) == TIE
    assert 0.0 < y[TIE] < 1e-6

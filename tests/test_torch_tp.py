"""The port's tensor (channel) parallelism (``svs_torch.parallel.tp``: the
2-D mesh, ``shard_state``, the channel-partitioned forward, the train and
eval steps, ``make_tp_apply``, ``fit`` and ``train_cli`` with ``--tp``) on
four gloo ranks on the CPU.

The module starts its ranks once (a ``launch.Ranks`` pool, one thread a
rank) and runs every case through them; what they run is in
``tests/torch_tp_workers.py``, which imports no JAX.  The reference is
svs_tpu's ``make_tp_train_step`` / ``make_tp_apply`` on the 8-device
virtual mesh, from the same weights (``state_dict_from_jax``) and the same
seeded numpy batches.  Bounds:

- one SGD step at the ``default`` preset's full width, 64 frames, float32,
  no dropout, on meshes (1, 4) and (2, 2), against svs_tpu's TP step and
  against the port's single-process ``make_train_step``:
  tests/test_tp.py's bounds, loss 1e-5 relative, parameters atol 1e-4 /
  rtol 1e-3, BN running statistics atol 1e-5 / rtol 1e-4;
- two Adam steps with dropout 0.5 (the narrow U-Net, 128 frames, float32
  and bf16): within
  ``__graft_entry__``'s envelope of the single-process steps
  (``dryrun.ENVELOPE``), which a different Dropout2d mask breaks; a
  (1, 1) mesh is ``make_train_step``'s bits;
- ``make_tp_apply`` against the unsharded eval forward: atol 2e-6
  (tests/test_tp.py:183);
- ``fit`` under TP writes a gathered ``.ckpt`` that svs_tpu loads, and a
  TP run resumed from a DP checkpoint gives the DP run's next epoch
  within tests/test_torch_dp.py's fit bounds (train 1e-4, validation 1e-3
  relative).
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_dp_workers as W
import torch_tp_workers as T
from test_torch_dp import (FIT, NARROW, _batch, _lines, _one_thread, _opts,
                           _sd, _songs)
from svs_torch.cli import train_cli
from svs_torch.parallel import dryrun
from svs_torch.parallel import tp as ttp
from svs_torch.parallel.launch import Ranks
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.models import unet as junet
from svs_tpu.parallel import tp as jtp
from svs_tpu.train import checkpoint as jck
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

# the default preset's widths at 64 frames, float32 (tests/test_tp.py's)
FULL = dict(input_len=64, dropout_rate=0.0, mr_mag_impl="fft")
SGD_LR = 0.01


@pytest.fixture(autouse=True)
def one_thread():
    with _one_thread():
        yield


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks(4, timeout=600)
    yield pool
    pool.close()


def _full_batch():
    """tests/test_tp.py's batch: 8 patches of 64 frames."""
    rng = np.random.default_rng(0)
    mix = rng.random((8, 512, 64)).astype(np.float32)
    ang = ((rng.random((8, 512, 64)) - 0.5) * 6).astype(np.float32)
    return {"mix": mix, "voc": (mix * 0.5).astype(np.float32),
            "mix_angle": ang, "voc_angle": ang}


def test_channel_rule_shards_for_real(ranks):
    """On a (1, 4) mesh every rank holds enc4's kernel cut to 32 of its
    128 output channels, deconv6's cut on its 32 input channels, the BN
    vectors and Adam's moments with their layer, deconv6's bias whole."""
    for r, held in enumerate(ranks.run(T.shards, (1, 4), FULL)):
        sd, mu = held["sd"], held["mu"]
        assert sd["conv4.0.weight"] == mu["conv4.0.weight"] \
            == (32, 64, 5, 5), r
        assert sd["deconv6.weight"] == mu["deconv6.weight"] \
            == (8, 1, 5, 5), r
        assert held["dims"]["deconv6.weight"] == 0
        assert sd["deconv6.bias"] == mu["deconv6.bias"] == (1,)
        assert sd["conv6.1.weight"] == sd["conv6.1.running_var"] == (128,)
        assert sd["deconv1.weight"] == (512, 64, 5, 5)  # (I, O / 4)
        assert sd["conv6.1.num_batches_tracked"] == ()


def test_a_rule_that_cuts_nothing_is_refused():
    """Over 3 model ranks no channel count of the preset divides: the step
    would run the unsharded forward on every rank, so shard_state
    refuses before any collective."""
    state = tstep.create_train_state(0, TConfig(**FULL), device="cpu")
    mesh = types.SimpleNamespace(model=types.SimpleNamespace(size=3))
    with pytest.raises(ValueError, match="cuts no leaf over 3"):
        ttp.shard_state(state, mesh)


@pytest.fixture(scope="module")
def sgd_ref():
    """svs_tpu's start state, the batch and the port's single-process SGD
    step from that state: (start, batch, want metrics, want state)."""
    jcfg = JConfig(**FULL)
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=SGD_LR)
    state = jstep.create_train_state(jax.random.key(0), jcfg, opt)
    start = _sd(state.params, state.bn_state)
    batch = _full_batch()
    with _one_thread():
        tstate = T._state(TConfig(**FULL), start, SGD_LR)
        tstate, m = tstep.make_train_step(TConfig(**FULL))(
            tstate, tstep.batch_to_device(batch, "cpu"))
    return (start, batch, {k: float(v) for k, v in m.items()},
            {k: v.numpy() for k, v in tstate.model.state_dict().items()})


def _close(got, want, what):
    for k, v in want.items():
        if "num_batches" in k:
            continue
        tol = (dict(atol=1e-5, rtol=1e-4) if "running" in k
               else dict(atol=1e-4, rtol=1e-3))
        np.testing.assert_allclose(got[k], v, err_msg=f"{what} {k}", **tol)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_tp_step_matches_svs_tpus_and_the_single_step(ranks, sgd_ref, shape):
    start, batch, want_m, want_sd = sgd_ref
    jcfg = JConfig(**FULL)
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=SGD_LR)
    mesh = jtp.make_2d_mesh(*shape)
    jstate, jaux = jtp.make_tp_train_step(mesh, jcfg, opt)(
        jtp.shard_state(jstep.create_train_state(jax.random.key(0), jcfg,
                                                 opt), mesh),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    jsd = _sd(jstate.params, jstate.bn_state)
    out = ranks.run(T.steps, shape, FULL, [batch], start, SGD_LR)
    got = out[0]
    for other in out[1:]:  # every rank gathers the same bits
        assert other["metrics"] == got["metrics"]
        for k, v in got["sds"][0].items():
            np.testing.assert_array_equal(other["sds"][0][k], v, err_msg=k)
    m = got["metrics"][0]
    for ref in (float(jaux["total"]), want_m["total"]):
        assert abs(m["total"] - ref) <= 1e-5 * abs(ref)
    assert abs(m["grad_norm"] - want_m["grad_norm"]) \
        <= 1e-3 * want_m["grad_norm"]
    _close(got["sds"][0], jsd, "svs_tpu")
    _close(got["sds"][0], want_sd, "make_train_step")
    # the updated state stays cut
    assert got["held"]["sd"]["conv4.0.weight"] == (128 // shape[1], 64, 5,
                                                   5)


@pytest.mark.parametrize("shape,dtype", [((1, 4), "float32"),
                                         ((2, 2), "float32"),
                                         ((2, 2), "bfloat16")])
def test_adam_steps_with_dropout_keep_the_single_steps_masks(ranks, shape,
                                                            dtype):
    """Two Adam steps with dropout 0.5 of B = 4: each Dropout2d mask is
    drawn at the global shape and cut to a data row's rows and a rank's
    channels, so each step is within the dry run's envelope of the
    single-process step from the same state and generator (in bf16 too,
    its gathers and partial sums in that dtype, 128 frames)."""
    cfg = dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5,
               compute_dtype=dtype)
    batches = [_batch(30, 4), _batch(31, 4)]
    got = ranks.run(T.steps, shape, cfg, batches)[0]
    tcfg = TConfig(**cfg)
    state = tstep.create_train_state(0, tcfg, device="cpu")
    step = tstep.make_train_step(tcfg)
    gen = torch.Generator().manual_seed(1)
    for i, b in enumerate(batches):
        if i:  # the next step from the TP step's state
            state.model.load_state_dict(
                {k: torch.from_numpy(v) for k, v in got["sds"][i - 1].items()})
        state, ref = step(state, tstep.batch_to_device(b, "cpu"), gen)
        out = dryrun.envelope(
            {k: torch.tensor(v) for k, v in got["metrics"][i].items()},
            {k: torch.from_numpy(v) for k, v in got["sds"][i].items()},
            ref, state, tcfg.learning_rate)
        assert out["ok"], (i, out)


def test_remat_recomputes_the_same_tp_step(ranks):
    """``cfg.remat`` on a (2, 2) mesh: each level, its gathers included,
    recomputed in the backward gives the steps without remat, bit for
    bit (``UNet.forward``'s contract)."""
    cfg = dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5)
    batches = [_batch(50, 4), _batch(51, 4)]
    want = ranks.run(T.steps, (2, 2), cfg, batches)[0]
    got = ranks.run(T.steps, (2, 2), dict(cfg, remat=True), batches)[0]
    assert got["metrics"] == want["metrics"]
    for k, v in want["sds"][-1].items():
        np.testing.assert_array_equal(got["sds"][-1][k], v, err_msg=k)


def test_world_of_one_is_make_train_steps_bits(ranks):
    """A (1, 1) mesh: two TP steps with Adam and dropout under the plain
    version of ``pallas_fused`` are ``make_train_step``'s, bit for bit."""
    cfg = dict(NARROW, mr_mag_impl="pallas_fused", dropout_rate=0.5)
    out = ranks.run(T.world_of_one, cfg, [_batch(20, 3), _batch(21, 3)])
    assert out[1:] == [None, None, None]
    want = out[0]["single"]
    got = out[0]["tp"]
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        for k, v in b.items():
            np.testing.assert_array_equal(a[k], v, err_msg=k)


def test_tp_apply_matches_unsharded(ranks):
    jcfg = JConfig(**FULL)
    st = jstep.create_train_state(jax.random.key(0), jcfg)
    mix = np.random.default_rng(0).random((8, 512, 64)).astype(np.float32)
    want, _ = junet.apply(st.params, st.bn_state, jnp.asarray(mix),
                          train=False, cfg=jcfg)
    got = ranks.run(T.apply, (2, 2), FULL, _sd(st.params, st.bn_state), mix)
    for g in got:
        np.testing.assert_allclose(g, np.asarray(want), atol=2e-6)
    mesh = jtp.make_2d_mesh(1, 4)
    sp = jtp.shard_state(st, mesh)
    jgot = jtp.make_tp_apply(mesh, jcfg)(sp.params, sp.bn_state,
                                         jnp.asarray(mix))
    np.testing.assert_allclose(got[0], np.asarray(jgot), atol=2e-6)


def test_tp_eval_step_is_the_global_weighted_mean(ranks):
    """B = 3 padded to the batch size 4 over the (2, 2) mesh's data rows:
    the single-device eval step's metrics (sum order apart)."""
    tcfg = TConfig(**dict(NARROW, mr_mag_impl="fft"))
    state = tstep.create_train_state(0, tcfg, device="cpu")
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    batch = _batch(40, 3)
    want = tstep.make_eval_step(tcfg)(state,
                                      tstep.batch_to_device(batch, "cpu"))
    got = ranks.run(T.evaluate, (2, 2), dict(NARROW, mr_mag_impl="fft"), sd,
                    batch, 4)
    assert all(g == got[0] for g in got)
    for k, v in want.items():
        assert abs(got[0][k] - float(v)) <= 1e-5 * abs(float(v)), k


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    return _songs(str(tmp_path_factory.mktemp("tp_songs")))


def _fit_bounds(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.startswith("Val ") == b.startswith("Val ")
        np.testing.assert_allclose(float(a.split()[-1]), float(b.split()[-1]),
                                   rtol=1e-3 if a.startswith("Val ")
                                   else 1e-4)


def test_fit_writes_a_ckpt_svs_tpu_loads_and_resumes_dps(ranks, songs,
                                                        tmp_path):
    """A two-epoch DP fit on the four ranks; a (2, 2) TP fit of its first
    epoch writes a ``.ckpt`` svs_tpu loads (the DP epoch's weights within
    the fit bounds); a TP run resumed from the DP first epoch's
    ``.ckpt`` logs the DP run's second epoch."""
    dp_out = str(tmp_path / "dp")
    r = ranks.run(W.fit, _opts(songs, dp_out), FIT)
    assert [x["code"] for x in r] == [0] * 4
    dp_half = str(tmp_path / "dp1")
    assert [x["code"] for x in ranks.run(
        W.fit, _opts(songs, dp_half, epoch=1), FIT)] == [0] * 4

    tp_out = str(tmp_path / "tp")
    r = ranks.run(T.fit, (2, 2), _opts(songs, tp_out, epoch=1), FIT)
    assert [x["code"] for x in r] == [0] * 4
    assert [x["steps"] for x in r] == [2] * 4
    assert r[0]["written"] == ["svs_best_t.ckpt", "svs_t.ckpt"]
    assert all(x["written"] == [] for x in r[1:])
    for x in r[1:]:
        for k, v in r[0]["state"].items():
            np.testing.assert_array_equal(x["state"][k], v, err_msg=k)
    _fit_bounds(_lines(tp_out, "log_t.txt"), _lines(dp_half, "log_t.txt"))
    jcfg = JConfig(**FIT)
    jstate, epoch, _ = jck.load(
        os.path.join(tp_out, "CKPT", "svs_t.ckpt"),
        jstep.create_train_state(jax.random.key(0), jcfg))
    assert epoch == 1 and int(jstate.step) == 2
    loaded = _sd(jstate.params, jstate.bn_state)
    for k, v in r[0]["state"].items():
        if "num_batches" not in k:
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)

    resumed = str(tmp_path / "resumed")
    r = ranks.run(T.fit, (1, 4), _opts(
        songs, resumed,
        load_path=os.path.join(dp_half, "CKPT", "svs_t.ckpt")), FIT)
    assert [x["code"] for x in r] == [0] * 4
    assert [x["steps"] for x in r] == [2] * 4
    _fit_bounds(_lines(resumed, "log_t.txt"), _lines(dp_out, "log_t.txt")[2:])
    with open(os.path.join(resumed, "LOG", "metrics_t.jsonl")) as f:
        assert [json.loads(x)["epoch"] for x in f] == [2, 2]


def test_tp_fit_remixes_the_global_batch_as_dp(ranks, songs, tmp_path):
    """With augmentation and the host pipeline, a (2, 2) TP epoch remixes
    each global batch before a data row keeps its rows, as the DP epoch
    on the four ranks does: the same losses within the fit bounds."""
    opts = dict(epoch=1, augment=True, device_data="off")
    dp_out, tp_out = str(tmp_path / "dp"), str(tmp_path / "tp")
    assert [x["code"] for x in ranks.run(
        W.fit, _opts(songs, dp_out, **opts), FIT)] == [0] * 4
    assert [x["code"] for x in ranks.run(
        T.fit, (2, 2), _opts(songs, tp_out, **opts), FIT)] == [0] * 4
    _fit_bounds(_lines(tp_out, "log_t.txt"), _lines(dp_out, "log_t.txt"))


def test_train_cli_tp_trains_on_four_ranks(ranks, songs, tmp_path):
    """``train_cli --tp 2 --dp`` on the four ranks (a (2, 2) mesh) at the
    narrow preset, one step and a validation pass, then ``--tp 4`` alone
    (a (1, 4) mesh) resuming from its ``.ckpt``; rank 0 writes."""
    common = ["--label", "c", "--train_folder", songs, "--valid_folder",
              songs, "--val_interval", "1", "--batch_size", "4",
              "--samples_per_song", "2", "--dtype", "float32", "--ckpt_dir",
              str(tmp_path / "CKPT"), "--log_dir", str(tmp_path / "LOG"),
              "--device", "cpu"]
    first = ["--load_path", str(tmp_path / "none.ckpt"), "--epoch", "1",
             "--tp", "2", "--dp"]
    assert ranks.run(W.cli, "train_cli", common + first) == [0] * 4
    again = ["--load_path", str(tmp_path / "CKPT" / "svs_c.ckpt"),
             "--epoch", "2", "--tp", "4"]
    assert ranks.run(W.cli, "train_cli", common + again) == [0] * 4
    lines = _lines(str(tmp_path), "log_c.txt")
    assert len(lines) == 4 and lines[1].startswith("Val ")
    assert all(np.isfinite(float(x.split()[-1])) for x in lines)
    assert sorted(os.listdir(tmp_path / "CKPT")) == ["svs_best_c.ckpt",
                                                     "svs_c.ckpt"]


@pytest.mark.parametrize("world,k,dp,want", [
    (4, 2, True, 2), (4, 4, False, 1), (4, 4, True, 1), (2, 2, False, 1),
    (4, 3, True, "does not divide"), (4, 2, False, "pass --dp"),
    (1, 2, False, "does not divide")])
def test_train_cli_tp_mesh_arithmetic(world, k, dp, want):
    if isinstance(want, int):
        assert train_cli.tp_mesh_shape(world, k, dp) == want
    else:
        with pytest.raises(ValueError, match=want):
            train_cli.tp_mesh_shape(world, k, dp)


@pytest.mark.parametrize("argv,says", [
    (["--tp", "0"], "positive shard count"),
    (["--tp", "2", "--cp"], "mutually exclusive"),
    (["--tp", "2", "--pp"], "mutually exclusive"),
    (["--tp", "2", "--dp", "--zero1"], "compose with --dp only"),
    (["--tp", "2", "--dp", "--fsdp"], "compose with --dp only"),
    (["--tp", "2", "--epoch_scan"], "not cp/tp/zero1/fsdp")])
def test_train_cli_refuses_what_svs_tpus_refuses(argv, says, capsys):
    with pytest.raises(SystemExit) as err:
        train_cli.main(["--label", "x", "--device", "cpu", *argv])
    assert err.value.code == 2
    assert says in capsys.readouterr().err

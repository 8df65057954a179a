"""The port's native checkpoints (``svs_torch.train.checkpoint``) against
svs_tpu's on the CPU: one ``.ckpt`` format, read and written by both.

A ``.ckpt`` is flax's msgpack; the port reads and writes it with its own
codec (``svs_torch.train.flax_msgpack``), held here byte for byte against
flax's.  Weights, BN statistics, Adam moments, the learning rate, the step,
the epoch and the extras cross in both directions exactly (float32 values
moved, HWIO against OIHW), and the next step after a resume agrees with
svs_tpu's next step within tests/test_torch_step.py's bounds: f32 ``fft``
loss rtol 1e-5, grad_norm rtol 1e-3; after an Adam update the parameters
within 2.1 lr (a parameter whose gradient is ~0 can round its sign either
way).  Narrow U-Net, (512, 128) patches, no dropout.
"""

import os

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from svs_torch.models import torch_import as t_import
from svs_torch.train import checkpoint as tck
from svs_torch.train import flax_msgpack as fm
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.train import checkpoint as jck
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), dropout_rate=0.0,
              mr_mag_impl="fft")
EXTRAS = {"best_val_loss": 0.75, "loss_list_total": [1.5, 1.25]}


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


def _jax(accum=1):
    cfg = JConfig(**NARROW)
    opt = jstep.make_optimizer(cfg, accum)
    return cfg, opt, jstep.create_train_state(jax.random.key(0), cfg, opt)


def _port(accum=1, seed=5):
    cfg = TConfig(**NARROW)
    return cfg, tstep.create_train_state(
        seed, cfg, tstep.make_optimizer(cfg, accum), device="cpu")


def _jax_step(cfg, opt, state, batch):
    return jstep.make_train_step(cfg, opt)(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(1))


def _port_step(cfg, state, batch):
    return tstep.make_train_step(cfg)(state,
                                      tstep.batch_to_device(batch, "cpu"))


def _inner(opt_state):
    return getattr(opt_state, "inner_opt_state", opt_state)


def _moments(jstate):
    """svs_tpu's Adam moments as the port's state-dict-keyed OIHW arrays."""
    adam = _inner(jstate.opt_state).inner_state[0]
    out = {}
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        sd = t_import.state_dict_from_jax(jax.tree.map(np.asarray, tree),
                                          jax.tree.map(np.asarray,
                                                       jstate.bn_state))
        out[key] = {k: v for k, v in sd.items() if "running" not in k
                    and "num_batches" not in k}
    return out


def _assert_same_state(jstate, tstate):
    sd = t_import.state_dict_from_jax(jax.tree.map(np.asarray, jstate.params),
                                      jax.tree.map(np.asarray,
                                                   jstate.bn_state))
    got = tstate.model.state_dict()
    for k, v in sd.items():
        if "num_batches" not in k:
            assert torch.equal(got[k], v), k
    inner = _inner(jstate.opt_state)
    count = int(inner.inner_state[0].count)
    moments = _moments(jstate)
    named = dict(tstate.model.named_parameters())
    for name, p in named.items():
        st = tstate.optimizer.state.get(p, {})
        if count == 0:
            assert not st
            continue
        assert int(st["step"]) == count
        assert torch.equal(st["exp_avg"], moments["exp_avg"][name]), name
        assert torch.equal(st["exp_avg_sq"], moments["exp_avg_sq"][name])
    assert tstep.get_learning_rate(tstate) == pytest.approx(
        float(inner.hyperparams["learning_rate"]), rel=1e-7)
    assert tstate.step == int(jstate.step)


def _tree():
    rng = np.random.default_rng(0)
    return {"a": {"0": rng.standard_normal((3, 5)).astype(np.float32),
                  "1": np.asarray(7, np.int32)},
            "count": np.asarray(300, np.int32), "e": {}, "i": 2 ** 40,
            "neg": -200, "f": 0.25, "s": "x" * 40, "n": None, "t": True,
            "l": [1.5, 2.5, -3], "big": rng.standard_normal(5000).astype(
                np.float32), "g": np.float32(1.5), "u8": np.arange(
                300, dtype=np.uint8)}


def test_msgpack_codec_matches_flax_byte_for_byte():
    tree = _tree()
    data = serialization.msgpack_serialize(tree)
    assert fm.packb(tree) == data
    got = fm.unpackb(data)
    want = serialization.msgpack_restore(data)
    assert got.keys() == want.keys()
    for k in tree:
        if isinstance(want[k], (np.ndarray, np.generic)):
            np.testing.assert_array_equal(got[k], want[k])
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        elif k != "a":
            assert got[k] == want[k], k
    np.testing.assert_array_equal(got["a"]["0"], tree["a"]["0"])


def test_msgpack_chunked_leaves_match_flax(monkeypatch):
    """flax splits leaves above MAX_CHUNK_SIZE bytes into chunk maps; at a
    64-byte limit both sides write and read the same bytes."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(50, dtype=np.float32).reshape(5, 10),
            "b": np.ones(4, np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert fm.packb(tree) == data
    got = fm.unpackb(data)
    np.testing.assert_array_equal(got["w"], tree["w"])
    np.testing.assert_array_equal(got["b"], tree["b"])


def test_jax_ckpt_resumes_in_port_with_the_same_next_step(tmp_path):
    jcfg, jopt, jstate = _jax()
    jstate, _ = _jax_step(jcfg, jopt, jstate, _batch(0))  # Adam count 1
    path = str(tmp_path / "j.ckpt")
    jck.save(path, jstate, epoch=3, extras=EXTRAS)

    tcfg, tstate = _port()  # other weights: all of them come from the file
    tstate, epoch, extras = tck.load(path, tstate)
    assert (epoch, extras) == (3, EXTRAS)
    _assert_same_state(jstate, tstate)

    template = jstep.create_train_state(jax.random.key(9), jcfg, jopt)
    jstate2, _, _ = jck.load(path, template)
    jstate2, jaux = _jax_step(jcfg, jopt, jstate2, _batch(1))
    tstate, taux = _port_step(tcfg, tstate, _batch(1))
    for k in ("l1", "mr", "total"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5)
    np.testing.assert_allclose(float(taux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=1e-3)
    assert tstate.step == int(jstate2.step) == 2


def test_port_ckpt_loads_in_jax(tmp_path):
    jcfg, jopt, jstate = _jax()
    tcfg, tstate = _port()
    tstate, _ = _port_step(tcfg, tstate, _batch(0))
    tstep.set_learning_rate(tstate, 3e-4)
    path = str(tmp_path / "t.ckpt")
    tck.save(path, tstate, epoch=4, extras=EXTRAS)
    jstate, epoch, extras = jck.load(path, jstate)
    assert (epoch, extras) == (4, EXTRAS)
    _assert_same_state(jstate, tstate)
    assert jstep.get_learning_rate(jstate) == pytest.approx(3e-4, rel=1e-7)
    # and the same next step from there
    jstate, jaux = _jax_step(jcfg, jopt, jstate, _batch(1))
    tstate, taux = _port_step(tcfg, tstate, _batch(1))
    np.testing.assert_allclose(float(taux["total"]), float(jaux["total"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux["grad_norm"]),
                               float(jaux["grad_norm"]), rtol=1e-3)


def test_accum_2_round_trips(tmp_path):
    """optax.MultiSteps' half-filled cycle crosses both ways: mini_step and
    the accumulated mean gradient, then the update that ends the cycle."""
    jcfg, jopt, jstate = _jax(accum=2)
    jstate, _ = _jax_step(jcfg, jopt, jstate, _batch(0))
    assert int(jstate.opt_state.mini_step) == 1
    path = str(tmp_path / "j2.ckpt")
    jck.save(path, jstate, epoch=1)
    tcfg, tstate = _port(accum=2)
    tstate, _, _ = tck.load(path, tstate)
    assert tstate.mini_step == 1 and tstate.step == 1
    acc = t_import.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.opt_state.acc_grads),
        jax.tree.map(np.asarray, jstate.bn_state))
    for (name, _), g in zip(tstate.model.named_parameters(),
                            tstate.acc_grads):
        assert torch.equal(g, acc[name]), name
    # the second microbatch ends the cycle on both sides
    jstate, _ = _jax_step(jcfg, jopt, jstate, _batch(1))
    tstate, _ = _port_step(tcfg, tstate, _batch(1))
    assert tstate.mini_step == 0 and tstate.acc_grads is None
    want = t_import.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state))
    for name, p in tstate.model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= \
            2.1 * tcfg.learning_rate, name
    # and back: the port's file loads in svs_tpu with its cycle state
    tstate, _ = _port_step(tcfg, tstate, _batch(2))
    path = str(tmp_path / "t2.ckpt")
    tck.save(path, tstate, epoch=2)
    loaded, epoch, _ = jck.load(path, jstate)
    assert epoch == 2 and int(loaded.opt_state.mini_step) == 1
    assert int(loaded.opt_state.gradient_step) == 1
    _assert_same_state(loaded, tstate)


def test_accum_layout_mismatch_is_refused_unless_weights_only(tmp_path):
    tcfg, tstate = _port(accum=2)
    path = str(tmp_path / "a.ckpt")
    tck.save(path, tstate)
    _, other = _port(accum=1)
    with pytest.raises(ValueError, match="--accum"):
        tck.load(path, other)
    _, other = _port(accum=1)
    tck.load(path, other, restore_opt=False)
    for k, v in tstate.model.state_dict().items():
        if "num_batches" not in k:
            assert torch.equal(other.model.state_dict()[k], v)


def test_pth_export_and_resume(tmp_path):
    tcfg, tstate = _port()
    tstate, _ = _port_step(tcfg, tstate, _batch(0))
    path = str(tmp_path / "w.pth")
    tck.export_pth(path, tstate, epoch=7)
    _, fresh = _port(seed=11)
    fresh, epoch, _ = tck.resume(path, fresh)
    assert epoch == 7
    for k, v in tstate.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


def test_async_saver_snapshots_before_the_next_step(tmp_path):
    """The worker writes what the state held when ``save`` was called,
    though the next step updates the parameters in place meanwhile; a
    worker's error surfaces at ``wait``; writes are atomic."""
    tcfg, tstate = _port()
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    saver = tck.AsyncSaver()
    path = str(tmp_path / "a" / "s.ckpt")
    saver.save(path, tstate, epoch=1, extras=EXTRAS)
    _port_step(tcfg, tstate, _batch(0))
    saver.wait()
    _, fresh = _port(seed=3)
    tck.load(path, fresh)
    for k, v in before.items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert not os.path.exists(path + ".tmp")
    blocker = tmp_path / "file"
    blocker.write_text("")
    saver.save(str(blocker / "x.ckpt"), tstate)
    with pytest.raises(OSError):
        saver.wait()
    saver.close()


def _songs(root, n_songs=2, t=160):
    rng = np.random.default_rng(0)
    for folder in ("mixture", "vocal"):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
    for i in range(n_songs):
        for folder in ("mixture", "vocal"):
            np.save(os.path.join(root, folder, f"{i:04d}_s{i}_spec.npy"),
                    rng.random((513, t)).astype(np.float32))
            ang = rng.uniform(-3, 3, (513, t)).astype(np.float32)
            np.save(os.path.join(root, folder, f"{i:04d}_s{i}_phase.npy"),
                    np.exp(1j * ang).astype(np.complex64))
    return root


def test_fresh_fit_equals_a_fit_resumed_from_its_checkpoint(tmp_path):
    """A fresh 2-epoch ``fit`` (a fresh Adam, step.BETAS and EPS) and a
    fresh 1-epoch ``fit`` resumed from its ``.ckpt`` for the second (the
    file's float32 betas and eps) end with the same bits: parameters, BN
    statistics, Adam's moments and step count, and the same log."""
    from svs_torch.train import loop as tloop

    songs = _songs(str(tmp_path / "songs"))
    cfg = TConfig(**dict(NARROW, samples_per_song=3))

    def fit(out, **kw):
        return tloop.fit(tloop.TrainOptions(**dict(dict(
            train_folder=songs, valid_folder=songs, load_path="none",
            label="t", epoch=2, batch_size=4, val_interval=1,
            ckpt_dir=os.path.join(out, "CKPT"),
            log_dir=os.path.join(out, "LOG"), progress=False,
            device="cpu"), **kw)), cfg)

    full = fit(str(tmp_path / "full"))
    half = str(tmp_path / "half")
    fit(half, epoch=1)
    resumed = fit(half, load_path=os.path.join(half, "CKPT", "svs_t.ckpt"))
    assert full.step == resumed.step == 4
    theirs = resumed.model.state_dict()
    for k, v in full.model.state_dict().items():
        if "num_batches" not in k:  # not in svs_tpu's format, never read
            assert torch.equal(theirs[k], v), k
    a, b = tck.snapshot(full), tck.snapshot(resumed)
    assert a.adam_count == b.adam_count == 4
    assert (a.betas, a.eps) == (b.betas, b.eps) == (tstep.BETAS, tstep.EPS)
    for k in a.exp_avg:
        assert torch.equal(a.exp_avg[k], b.exp_avg[k]), k
        assert torch.equal(a.exp_avg_sq[k], b.exp_avg_sq[k]), k
    with open(os.path.join(half, "LOG", "log_t.txt")) as f, \
            open(str(tmp_path / "full" / "LOG" / "log_t.txt")) as g:
        assert f.read() == g.read()

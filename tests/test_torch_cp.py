"""The port's context (time) parallelism (``svs_torch.parallel.halo``: the
halo exchange, the time-sharded forward, the CP train step,
``separate_magnitude_mesh(mode="whole")``, the time-sharded
``DeviceDataset``, ``fit(parallel="cp")``, ``train_cli --cp`` and
``infer_cli --cp``) on four gloo ranks on the CPU.

The module starts its ranks once (a ``launch.Ranks`` pool, one thread a
rank) and runs every case through them; what they run is in
``tests/torch_cp_workers.py``, which imports no JAX.  The reference is
svs_tpu's ``halo`` on the virtual CPU mesh, from the same weights
(``state_dict_from_jax``) and the same seeded numpy batches, at
tests/test_halo.py's bounds:

- the halo exchange against a slice of the zero-padded whole tensor
  (float32, exact), and its adjoint through ``torch.autograd.gradcheck``
  in float64 on 2 and 4 ranks;
- ``make_time_sharded_apply`` at the ``default`` widths against svs_tpu's
  and the port's unsharded eval forward: atol 3e-5;
- one CP train step (Adam, float32, no dropout, the narrow U-Net) on 4
  ranks against svs_tpu's ``make_cp_train_step``: loss rtol 1e-6,
  ``grad_norm`` rtol 1e-4, BN running statistics atol 1e-5, parameters
  max |d| <= 2.1e-3 and mean < 2e-4 (Adam's first update is ~lr *
  sign(grad), which a reordered sum may flip where the gradient is ~0);
- with dropout 0.5, the CP steps against the port's own
  ``make_train_step`` from the same state and generator within
  ``__graft_entry__``'s envelope (``dryrun.ENVELOPE``), which a different
  Dropout2d mask breaks; remat recomputes the same step bit for bit;
- the whole-song decode against svs_tpu's
  ``separate_magnitude_time_sharded``: atol 3e-5; the vocal and
  accompaniment outputs sum to the mix within 1e-5; at a length the two
  whole-song decodes pad apart, each of the port's against svs_tpu's; the
  decode as its cached program (routed through the program objects on
  the CPU) at a world of one and on 4 ranks: the eager decode's bits;
- ``fit(parallel="cp")``: the device and host pipelines give the same
  bits, and its epoch is the single-device fit's within
  tests/test_torch_dp.py's fit bounds (train 1e-4, validation 1e-3
  relative).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_cp_workers as C
import torch_dp_workers as W
from test_torch_dp import (FIT, NARROW, _batch, _fake, _lines, _one_thread,
                           _opts, _sd, _songs)
from svs_torch.cli import infer_cli, train_cli
from svs_torch.data import device_data as tdd
from svs_torch.data.dataset import PatchDataset
from svs_torch.infer import separate as tsep
from svs_torch.models.unet import UNet
from svs_torch.parallel import dryrun
from svs_torch.parallel import halo as thalo
from svs_torch.parallel.launch import Ranks
from svs_torch.train import loop as tloop
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.infer import separate as jsep
from svs_tpu.parallel import dp as jdp
from svs_tpu.parallel import halo as jhalo
from svs_tpu.parallel import mesh as jmesh
from svs_tpu.train import checkpoint as jck
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

# tests/test_halo.py's CP step geometry on the narrow U-Net: 256 frames,
# 64 a rank over 4 ranks
STEP = dict(NARROW, input_len=256, mr_mag_impl="fft")


@pytest.fixture(autouse=True)
def one_thread():
    with _one_thread():
        yield


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks(4, timeout=600)
    yield pool
    pool.close()


@pytest.mark.parametrize("n,h,t_loc", [(2, 2, 4), (2, 2, 2), (4, 2, 4),
                                       (4, 1, 1)])
def test_halo_exchange_and_its_adjoint(ranks, n, h, t_loc):
    """Each rank's block with ``h`` columns of its neighbours (zeros at the
    ends) is its slice of the zero-padded whole tensor, exactly; the
    adjoint passes gradcheck in float64 (2 x 2 edge columns over blocks
    of 2 and of 1 column included: the deepest levels' geometry)."""
    out = ranks.run(C.halo_check, n, h, t_loc)
    assert out[n:] == [None] * (4 - n)
    for r in out[:n]:
        assert r["shape"] == [1, 2, 2, t_loc + 2 * h]
        assert r["max_abs_err"] == 0.0
        assert r["gradcheck"]


def test_time_sharded_apply_matches_svs_tpus_and_the_unsharded(ranks):
    """The ``default`` widths, T = 512 over 4 ranks (128 a rank)."""
    jcfg = JConfig()
    st = jstep.create_train_state(jax.random.key(0), jcfg)
    mix = np.random.default_rng(0).random((1, 512, 512)).astype(np.float32)
    sd = _sd(st.params, st.bn_state)
    got = ranks.run(C.apply, {}, sd, mix)
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    jgot = jhalo.make_time_sharded_apply(jmesh.make_mesh(4), jcfg)(
        st.params, st.bn_state, jnp.asarray(mix))
    np.testing.assert_allclose(got[0], np.asarray(jgot), atol=3e-5)
    model = UNet(TConfig())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(mix)).numpy()
    np.testing.assert_allclose(got[0], want, atol=3e-5)


def _loss_batch(seed, b, t):
    """tests/test_halo.py's batch draws."""
    rng = np.random.default_rng(seed)
    return {
        "mix": rng.random((b, 512, t)).astype(np.float32),
        "voc": rng.random((b, 512, t)).astype(np.float32) * 0.5,
        "mix_angle": (rng.random((b, 512, t)).astype(np.float32) - 0.5) * 6,
        "voc_angle": (rng.random((b, 512, t)).astype(np.float32) - 0.5) * 6,
    }


def _jax_cp_step(batch):
    """svs_tpu's CP step on 4 virtual devices from its state of key 0:
    (the start state dict, the metrics, the state dict after)."""
    jcfg = JConfig(**STEP)
    mesh = jmesh.make_mesh(4)
    opt = jstep.make_optimizer(jcfg)
    state = jstep.create_train_state(jax.random.key(0), jcfg, opt)
    start = _sd(state.params, state.bn_state)  # the step donates the state
    state, aux = jhalo.make_cp_train_step(mesh, jcfg, opt)(
        jdp.replicate_state(state, mesh), jhalo.shard_batch_time(mesh, batch),
        jax.random.key(1))
    return (start, {k: float(v) for k, v in aux.items()},
            _sd(state.params, state.bn_state))


@pytest.mark.parametrize("weighted", [False, True])
def test_cp_step_matches_svs_tpus(ranks, weighted):
    """One CP step of B = 2 (or of B = 3 whose last row has weight 0,
    tests/test_halo.py:164) on 4 ranks against svs_tpu's; the weighted
    batch's loss is the 2-row batch's."""
    batch = _loss_batch(0, 2, 256)
    if weighted:
        batch = {k: np.concatenate([v, np.zeros_like(v[:1])])
                 for k, v in batch.items()}
        batch["weight"] = np.asarray([1.0, 1.0, 0.0], np.float32)
    start, jaux, jsd = _jax_cp_step(batch)
    out = ranks.run(C.steps, 4, STEP, [batch], start)
    for other in out[1:]:  # every rank holds the same bits
        assert other["metrics"] == out[0]["metrics"]
        for k, v in out[0]["sds"][0].items():
            np.testing.assert_array_equal(other["sds"][0][k], v, err_msg=k)
    m, sd = out[0]["metrics"][0], out[0]["sds"][0]
    np.testing.assert_allclose(m["total"], jaux["total"], rtol=1e-6)
    np.testing.assert_allclose(m["grad_norm"], jaux["grad_norm"], rtol=1e-4)
    deltas = []
    for k, v in jsd.items():
        if "num_batches" in k:
            continue
        if "running" in k:
            np.testing.assert_allclose(sd[k], v, atol=1e-5, err_msg=k)
        else:
            deltas.append(np.abs(sd[k] - v))
    assert max(float(d.max()) for d in deltas) <= 2.1e-3
    assert sum(float(d.sum()) for d in deltas) \
        / sum(d.size for d in deltas) < 2e-4
    if weighted:
        two = ranks.run(C.steps, 4, STEP, [_loss_batch(0, 2, 256)],
                        start)[0]["metrics"][0]
        np.testing.assert_allclose(m["total"], two["total"], rtol=1e-6)


@pytest.mark.parametrize("n", [1, 4])
def test_cp_steps_keep_the_single_steps_dropout_masks(ranks, n):
    """Two Adam steps with dropout 0.5 of B = 3 at 256 frames, on a world
    of one and on 4 ranks: every rank draws the whole batch's Dropout2d
    masks in ``UNet.forward``'s order, so each step is within the dry
    run's envelope of ``make_train_step`` from the same state and
    generator."""
    cfg = dict(STEP, dropout_rate=0.5)
    batches = [_batch(30, 3, 256), _batch(31, 3, 256)]
    got = ranks.run(C.steps, n, cfg, batches)[0]
    tcfg = TConfig(**cfg)
    state = tstep.create_train_state(0, tcfg, device="cpu")
    step = tstep.make_train_step(tcfg)
    gen = torch.Generator().manual_seed(1)
    for i, b in enumerate(batches):
        if i:  # the next step from the CP step's state
            state.model.load_state_dict(
                {k: torch.from_numpy(v) for k, v in got["sds"][i - 1].items()})
        b = tstep.batch_to_device(b, "cpu")
        b["weight"] = torch.ones(3)
        state, ref = step(state, b, gen)
        out = dryrun.envelope(
            {k: torch.tensor(v) for k, v in got["metrics"][i].items()},
            {k: torch.from_numpy(v) for k, v in got["sds"][i].items()},
            ref, state, tcfg.learning_rate)
        assert out["ok"], (n, i, out)


def test_remat_recomputes_the_same_cp_step(ranks):
    """``cfg.remat`` on 4 ranks: each level, its halo exchange and BN sums
    included, recomputed in the backward gives the steps without remat,
    bit for bit."""
    cfg = dict(STEP, dropout_rate=0.5)
    batches = [_batch(50, 2, 256), _batch(51, 2, 256)]
    want = ranks.run(C.steps, 4, cfg, batches)[0]
    got = ranks.run(C.steps, 4, dict(cfg, remat=True), batches)[0]
    assert got["metrics"] == want["metrics"]
    for k, v in want["sds"][-1].items():
        np.testing.assert_array_equal(got["sds"][-1][k], v, err_msg=k)


def test_shard_batch_time_validates_granularity():
    """tests/test_halo.py:230: 128 frames over 4 ranks."""
    with pytest.raises(ValueError, match="multiple of 256"):
        thalo.shard_batch_time(_fake(0, 4), _loss_batch(0, 1, 128))


def test_whole_song_decode(ranks):
    """``separate_magnitude_mesh(mode="whole")`` of a 700-frame song (the
    pad path: 768 frames over 4 ranks) at the ``default`` widths: the DC
    row zero, vocals and accompaniment summing to the mix, rank 0 alone
    returning; svs_tpu's ``separate_magnitude_time_sharded`` within 3e-5
    (tests/test_halo.py:240)."""
    jcfg = JConfig()
    st = jstep.create_train_state(jax.random.key(0), jcfg)
    sd = _sd(st.params, st.bn_state)
    mag = np.random.default_rng(2).random((513, 700)).astype(np.float32)
    out = ranks.run(C.decode, {}, sd, mag, True)
    acc = ranks.run(C.decode, {}, sd, mag, False)
    assert out[1:] == acc[1:] == [None] * 3
    out, acc = out[0], acc[0]
    assert out.shape == (513, 700)
    assert (out[0] == 0).all() and (out[1:] <= mag[1:] + 1e-5).all()
    np.testing.assert_allclose(out[1:] + acc[1:], mag[1:], atol=1e-5)
    want = jhalo.separate_magnitude_time_sharded(
        st.params, st.bn_state, mag, jmesh.make_mesh(4), cfg=jcfg)
    np.testing.assert_allclose(out, want, atol=3e-5)


@pytest.mark.parametrize("n", [1, 4])
def test_whole_song_decode_programs_are_their_eager_bits(ranks, n):
    """The time-sharded decode as the cached decode program of its key
    (the model, the mesh and the padded shape: the local block, the
    forward with its halo exchanges and the gather in one program),
    routed through the program objects on the CPU, over a world of one
    and over 4 ranks: both ways of ``vocal_solo``, twice each, the eager
    decode's bits on rank 0; every rank's gathered mask the eager one's
    and the same on every rank; one program for all of them (``vocal_solo``
    is applied outside it); and svs_tpu's
    ``separate_magnitude_time_sharded`` over 4 devices within 3e-5."""
    jcfg = JConfig()
    st = jstep.create_train_state(jax.random.key(0), jcfg)
    sd = _sd(st.params, st.bn_state)
    mag = np.random.default_rng(2).random((513, 700)).astype(np.float32)
    got = ranks.run(C.decode_programs, n, {}, sd, mag)
    assert got[n:] == [None] * (4 - n)
    for r, out in enumerate(got[:n]):
        assert out["program_builds"] == (1, 1)
        assert out["eager_builds"] == (0, 0)
        np.testing.assert_array_equal(out["program_mask"],
                                      out["eager_mask"])
        np.testing.assert_array_equal(out["program_mask"],
                                      got[0]["program_mask"])
        for a, b in zip(out["program"], out["eager"]):
            if r:
                assert a is None and b is None
            else:
                np.testing.assert_array_equal(a, b)
    if n == 4:
        want = jhalo.separate_magnitude_time_sharded(
            st.params, st.bn_state, mag, jmesh.make_mesh(4), cfg=jcfg)
        np.testing.assert_allclose(got[0]["program"][0], want, atol=3e-5)


def test_whole_song_decodes_differ_as_svs_tpus_do(ranks):
    """A 768-frame song, which the CP decode over 4 ranks leaves as it is
    and ``separate_magnitude(mode="whole")`` pads to 1024 frames: the model
    sees a different zero tail, so the two decodes differ near the end.
    Each of the port's two is svs_tpu's within 3e-5, so svs_tpu's two
    differ alike."""
    jcfg = JConfig()
    st = jstep.create_train_state(jax.random.key(0), jcfg)
    sd = _sd(st.params, st.bn_state)
    mag = np.random.default_rng(4).random((513, 768)).astype(np.float32)
    cp = ranks.run(C.decode, {}, sd, mag, True)[0]
    model = UNet(TConfig())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    whole = tsep.separate_magnitude(model.eval(), mag, mode="whole",
                                    device="cpu")
    jcp = jhalo.separate_magnitude_time_sharded(
        st.params, st.bn_state, mag, jmesh.make_mesh(4), cfg=jcfg)
    jwhole = jsep.separate_magnitude(st.params, st.bn_state, mag, cfg=jcfg,
                                     mode="whole")
    np.testing.assert_allclose(cp, jcp, atol=3e-5)
    np.testing.assert_allclose(whole, jwhole, atol=3e-5)
    assert np.abs(jwhole - jcp).max() > 100 * 3e-5


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    return _songs(str(tmp_path_factory.mktemp("cp_songs")))


@pytest.mark.parametrize("augment", [False, True])
def test_time_sharded_device_dataset_is_the_host_batch_cut(songs, augment):
    """Each rank's step inputs from the time-sharded device dataset
    (remixed with ``augment``: the remix is row-local and elementwise in
    time) are ``shard_batch_time`` of the host pipeline's remixed batch,
    bit for bit."""
    from svs_torch.data.augment import Augmenter

    host = PatchDataset(songs, samples_per_song=5, input_len=128)
    for r in (0, 1):
        ds = tdd.DeviceDataset(host, mesh=_fake(r), time_sharded=True)
        aug_d = Augmenter().for_epoch(3) if augment else None
        aug_h = Augmenter().for_epoch(3) if augment else None
        pairs = zip(ds.batches(4, seed=9), host.batches(4, seed=9))
        for i, (db, hb) in enumerate(pairs):
            if augment:
                db = aug_d(db)
                hb = aug_h(tstep.batch_to_device(hb, "cpu"))
            want = thalo.shard_batch_time(_fake(r), hb)
            assert sorted(db) == sorted(want)
            for k, v in want.items():
                assert db[k].shape == v.shape, k
                torch.testing.assert_close(db[k], v, rtol=0, atol=0)
        assert i == 2  # 10 patches: two full batches and a tail of 2


def test_time_sharded_device_dataset_refusals(songs, monkeypatch):
    host = PatchDataset(songs, samples_per_song=2, input_len=128)
    with pytest.raises(ValueError, match="requires a mesh"):
        tdd.DeviceDataset(host, time_sharded=True)
    # refused before the planes are packed
    monkeypatch.setattr(tdd, "_pack_planes", None)
    with pytest.raises(ValueError, match="multiple of 256"):
        tdd.DeviceDataset(host, mesh=_fake(0, 4), time_sharded=True)


@pytest.fixture(scope="module")
def single_fit(songs, tmp_path_factory):
    """One epoch of the single-device fit that the CP fits are held
    against, and the second epoch resumed from its ``.ckpt``."""
    out = str(tmp_path_factory.mktemp("single"))
    with _one_thread():
        tloop.fit(tloop.TrainOptions(**_opts(songs, out, epoch=1),
                                     device="cpu"), TConfig(**FIT))
    return out


def _fit_bounds(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.startswith("Val ") == b.startswith("Val ")
        np.testing.assert_allclose(float(a.split()[-1]), float(b.split()[-1]),
                                   rtol=1e-3 if a.startswith("Val ")
                                   else 1e-4)


def test_cp_fit_device_and_host_pipelines_and_checkpoint(ranks, songs,
                                                         single_fit,
                                                         tmp_path):
    """One epoch of a 2-rank CP fit (128 frames, 64 a rank) with the
    dataset on the device and on the host: the same bits, the single
    fit's losses within the fit bounds, rank 0 writing alone; svs_tpu
    loads its ``.ckpt``, and the single-device fit resumes from it."""
    runs = {}
    for mode in ("on", "off"):
        out = str(tmp_path / mode)
        r = ranks.run(C.fit, 2, _opts(songs, out, epoch=1, device_data=mode),
                      FIT)
        assert r[2:] == [None, None]
        assert [x["code"] for x in r[:2]] == [0, 0]
        assert [x["steps"] for x in r[:2]] == [2, 2]
        assert r[0]["written"] == ["svs_best_t.ckpt", "svs_t.ckpt"]
        assert r[1]["written"] == []
        for k, v in r[0]["state"].items():
            np.testing.assert_array_equal(r[1]["state"][k], v, err_msg=k)
        runs[mode] = (out, r[0]["state"])
    for k, v in runs["on"][1].items():
        np.testing.assert_array_equal(runs["off"][1][k], v, err_msg=k)
    out = runs["on"][0]
    assert _lines(out, "log_t.txt") == _lines(runs["off"][0], "log_t.txt")
    _fit_bounds(_lines(out, "log_t.txt"), _lines(single_fit, "log_t.txt"))

    ckpt = os.path.join(out, "CKPT", "svs_t.ckpt")
    jstate, epoch, _ = jck.load(
        ckpt, jstep.create_train_state(jax.random.key(0), JConfig(**FIT)))
    assert epoch == 1 and int(jstate.step) == 2
    loaded = _sd(jstate.params, jstate.bn_state)
    for k, v in runs["on"][1].items():
        if "num_batches" not in k:
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    state = tloop.fit(tloop.TrainOptions(
        **_opts(songs, out, epoch=2, load_path=ckpt), device="cpu"),
        TConfig(**FIT))
    assert state.step == 4
    lines = _lines(out, "log_t.txt")
    assert len(lines) == 4 and all(np.isfinite(float(x.split()[-1]))
                                   for x in lines)


def test_fit_refuses_what_svs_tpu_refuses(songs, tmp_path):
    base = _opts(songs, str(tmp_path), parallel="cp", device="cpu")
    for kw, says in ((dict(), "needs a data mesh"),
                     (dict(mesh=_fake(0), zero1=True), "compose with dp"),
                     (dict(mesh=_fake(0), epoch_scan=True),
                      "not cp/tp/zero1/fsdp")):
        with pytest.raises(ValueError, match=says):
            tloop.fit(tloop.TrainOptions(**dict(base, **kw)),
                      TConfig(**FIT))


def test_train_cli_and_infer_cli_cp(ranks, songs, tmp_path):
    """``train_cli --cp`` on the 4 ranks for an epoch with validation (the
    ``p1207`` preset's 512-frame patches, 128 a rank), then ``infer_cli
    --cp --mode whole`` from its ``.ckpt`` against the unsharded decode of
    a 1000-frame song, which both pad to 1024 frames; rank 0 writes."""
    argv = ["--label", "c", "--train_folder", songs, "--valid_folder",
            songs, "--val_interval", "1", "--batch_size", "2",
            "--samples_per_song", "1", "--preset", "p1207", "--dtype",
            "float32", "--ckpt_dir", str(tmp_path / "CKPT"), "--log_dir",
            str(tmp_path / "LOG"), "--device", "cpu", "--load_path",
            str(tmp_path / "none"), "--epoch", "1", "--cp"]
    assert ranks.run(W.cli, "train_cli", argv) == [0] * 4
    lines = _lines(str(tmp_path), "log_c.txt")
    assert len(lines) == 2 and lines[1].startswith("Val ")
    assert all(np.isfinite(float(x.split()[-1])) for x in lines)
    assert sorted(os.listdir(tmp_path / "CKPT")) == ["svs_best_c.ckpt",
                                                     "svs_c.ckpt"]
    mix = tmp_path / "mix"
    mix.mkdir()
    mag = np.random.default_rng(4).random((513, 1000)).astype(np.float32)
    np.save(mix / "0000_song_spec.npy", mag)
    argv = ["--model_path", str(tmp_path / "CKPT" / "svs_c.ckpt"),
            "--mixture_folder", str(mix), "--mode", "whole", "--dtype",
            "float32", "--device", "cpu"]
    cp_out, one_out = tmp_path / "cp", tmp_path / "one"
    assert ranks.run(W.cli, "infer_cli",
                     argv + ["--tar", str(cp_out), "--cp"]) == [0] * 4
    assert infer_cli.main(argv + ["--tar", str(one_out)]) == 0
    assert os.listdir(cp_out) == os.listdir(one_out) == ["0000_song_spec.npy"]
    got = np.load(cp_out / "0000_song_spec.npy")
    want = np.load(one_out / "0000_song_spec.npy")
    assert got.shape == (513, 1000)
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("cli,argv,says", [
    (train_cli, ["--cp", "--dp"], "mutually exclusive with --dp/--tp"),
    (train_cli, ["--cp", "--tp", "2"], "mutually exclusive"),
    (train_cli, ["--cp", "--pp"], "mutually exclusive"),
    (train_cli, ["--cp", "--epoch_scan"], "not cp/tp/zero1/fsdp"),
    (infer_cli, ["--sp", "--cp", "--mode", "whole"], "mutually exclusive"),
    (infer_cli, ["--cp"], "pass --mode whole"),
    (infer_cli, ["--sp", "--mode", "whole"], "use --cp")])
def test_clis_refuse_what_svs_tpus_refuse(cli, argv, says, capsys):
    base = (["--label", "x"] if cli is train_cli else
            ["--model_path", "m", "--tar", "t", "--mixture_folder", "f"])
    with pytest.raises(SystemExit) as err:
        cli.main(base + ["--device", "cpu"] + argv)
    assert err.value.code == 2
    assert says in capsys.readouterr().err

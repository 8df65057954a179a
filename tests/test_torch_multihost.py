"""The port's multi-host training (``svs_torch.parallel.multihost``,
``MultiHostDeviceDataset``, ``Augmenter.apply_sharded``, ``fit`` over a
mesh of several hosts, ``train_cli --coordinator``) on the CPU.

The module starts one pool of four gloo ranks cut into two hosts of two
(``launch.Ranks(4, hosts=2)``) and runs every multi-rank case through it;
what the ranks run is in ``tests/torch_mh_workers.py``, which imports no
JAX.  svs_tpu's own multi-process cases (``tests/test_multiprocess.py``)
are slow-marked subprocess pairs; here the same contracts are held against
svs_tpu's functions in this process, on its virtual CPU mesh:

- ``process_shard``, ``global_batch_from_local`` (each host's two ranks'
  blocks put together against svs_tpu's on a 2-device mesh, with and
  without ``pad_to``, and its two ``ValueError``s), the host schedule
  (song shard, ``local_bs``, ``train_steps``, the host's epoch seed)
  against svs_tpu's ``process_shard`` and ``PatchDataset.index_batches``,
  ``MultiHostDeviceDataset`` and ``apply_sharded`` against svs_tpu's: the
  same values (the data bit for bit; the remix, a different trig
  implementation, within svs_tpu's own bound against its numpy oracle,
  rtol 1e-4 and atol 1e-6);
- the two-host DP step (float32, the narrow U-Net, ``fft``, no dropout)
  against svs_tpu's ``make_train_step`` on the host-major padded global
  batch with its ``weight``: tests/test_torch_dp.py's bounds (loss 1e-5
  relative, the gradient 1e-5 relative L2, BN statistics 1e-5 absolute);
- the port against itself: a two-host ``fit`` (two hosts of one rank, 3
  songs, batch 5, validation each epoch) runs in lockstep and writes once,
  with the songs on the device and on the host giving the same bits; a
  two-host CP ``fit`` is the one-host two-rank CP ``fit`` bit for bit; a
  SIGTERM to one host stops both, and their resume, like a resume where
  host 1 has no checkpoint (``sync_resume``), is the uninterrupted run bit
  for bit; ``train_cli --coordinator`` as two processes.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_mh_workers as M
from test_torch_dp import (_GRAB, FIT, NARROW, _batch, _lines, _one_thread,
                           _opts, _sd, _songs)
from svs_torch.data.dataset import PatchDataset
from svs_torch.parallel import dryrun
from svs_torch.parallel import mesh as tmesh
from svs_torch.parallel import multihost as tmh
from svs_torch.parallel.launch import Ranks
from svs_torch.train import loop as tloop
from svs_tpu.data import augment as jaugment
from svs_tpu.data import dataset as jdataset
from svs_tpu.data import device_data as jdd
from svs_tpu.parallel import mesh as jmesh
from svs_tpu.parallel import multihost as jmh
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANES = ("mix", "voc", "mix_angle", "voc_angle")


@pytest.fixture(autouse=True)
def one_thread():
    with _one_thread():
        yield


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks(4, hosts=2, timeout=600)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    """Three songs: an uneven shard over two hosts."""
    return _songs(str(tmp_path_factory.mktemp("mh_songs")), n_songs=3)


def _fake(rank, size=4, hosts=2):
    """A rank's view for the host-side distributors, which call no
    collective."""
    return tmesh.Mesh(None, rank, size, torch.device("cpu"), hosts=hosts)


def test_make_mesh_reads_the_hosts(ranks):
    """``Ranks(4, hosts=2)`` sets torchrun's node environment: two hosts of
    two consecutive ranks."""
    assert ranks.run(M.layout) == [(2, 0, 0, 2), (2, 0, 1, 2),
                                   (2, 1, 0, 2), (2, 1, 1, 2)]


def test_a_layout_that_is_not_host_major_is_refused(monkeypatch):
    """RANK 0 on host 1 of one rank a host is not host-major."""
    for k, v in dict(RANK="0", WORLD_SIZE="1", GROUP_RANK="1",
                     LOCAL_WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="must be host-major"):
        tmesh._host_layout(0, 1, None)
    monkeypatch.setenv("GROUP_RANK", "0")
    assert tmesh._host_layout(0, 1, None) == 1


@pytest.mark.parametrize("n,hosts", [(7, 2), (3, 2), (2, 3), (10, 4)])
def test_process_shard_matches_svs_tpus(n, hosts):
    items = [f"{i:04d}_spec.npy" for i in range(n)]
    for h in range(hosts):
        assert tmh.process_shard(items, h, hosts) == \
            jmh.process_shard(items, h, hosts)


@pytest.mark.parametrize("rows,pad_to", [(4, None), (3, 4), (5, 6), (2, 2)])
def test_global_batch_from_local_matches_svs_tpus(rows, pad_to):
    """Per host: the blocks of its two ranks put together are svs_tpu's
    global array on the 2-device mesh of one process (its
    ``make_array_from_process_local_data``), the ``weight`` included."""
    jm = jmesh.make_mesh(2)
    for h in (0, 1):
        batch = _batch(50 + h, rows, t=16)
        want = jmh.global_batch_from_local(jm, batch, pad_to=pad_to)
        got = [tmh.global_batch_from_local(_fake(2 * h + r), batch, pad_to)
               for r in (0, 1)]
        assert sorted(got[0]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(
                torch.cat([g[k] for g in got]).numpy(), np.asarray(v),
                err_msg=k)


def test_global_batch_from_local_keeps_svs_tpus_refusals():
    batch = _batch(60, 3, t=16)
    for pad_to, says in ((3, "not a multiple of this host's data-axis "
                          "quota 2"), (2, "local batch rows 3 exceed")):
        with pytest.raises(ValueError, match=says):
            tmh.global_batch_from_local(_fake(0), batch, pad_to)
        with pytest.raises(ValueError, match=says):
            jmh.global_batch_from_local(jmesh.make_mesh(2), batch,
                                        pad_to=pad_to)
    with pytest.raises(ValueError, match="pass pad_to"):
        tmh.global_batch_from_local(_fake(0), batch)


def test_two_host_dp_step_matches_svs_tpus(ranks):
    """Hosts of 3 and 2 real rows, padded to 4 (2 a rank): the global
    metrics, the summed gradient and the BN statistics against svs_tpu's
    single-device step on the host-major padded batch."""
    cfg = dict(NARROW, mr_mag_impl="fft")
    jcfg = JConfig(**cfg)
    state = jstep.create_train_state(jax.random.key(0), jcfg, _GRAB)
    start = _sd(state.params, state.bn_state)  # the step donates the state
    locals_, local_bs = dryrun.host_batches(_batch(7, 5), 2)
    pad_to = tmh.pad_rows(local_bs, _fake(0))
    assert (local_bs, pad_to) == (3, 4)
    glob = dryrun.host_major(locals_, pad_to)
    jstate, jaux = jstep.make_train_step(jcfg, _GRAB)(
        state, glob, jax.random.key(1))
    jaux = {k: float(v) for k, v in jaux.items()}
    want = _sd(jstate.opt_state, jstate.bn_state)  # the gradient, by name
    out = ranks.run(M.dp_grads, cfg, start, locals_, pad_to)
    m0, g0, bn0 = out[0]
    for m, g, bn in out[1:]:
        assert m == m0
        for k in g0:
            np.testing.assert_array_equal(g[k], g0[k])
    for k in ("l1", "mr", "total"):
        assert abs(m0[k] - jaux[k]) <= 1e-5 * abs(jaux[k]), k
    num = sum(float(((g0[k] - want[k]) ** 2).sum()) for k in g0)
    den = sum(float((want[k] ** 2).sum()) for k in g0)
    assert np.sqrt(num / den) <= 1e-5
    for k in bn0:
        np.testing.assert_allclose(bn0[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("n_songs,hosts", [(3, 2), (2, 3)])
def test_host_schedule_matches_svs_tpus(tmp_path, n_songs, hosts):
    """Each host's (song, start) stream of two epochs: the port's shard,
    ``host_schedule`` and ``epoch_seed`` against svs_tpu's
    ``process_shard`` (wrapping around where hosts outnumber songs),
    ``local_bs``, ``train_steps`` and host seed (loop.py:175-197,651)."""
    folder = _songs(str(tmp_path), n_songs=n_songs)
    batch_size, seed = 5, 3
    for h in range(hosts):
        ds = PatchDataset(folder, samples_per_song=3, input_len=128)
        local_bs, steps = tmh.host_schedule(batch_size, len(ds), hosts)
        tmh.shard_songs(ds, h, hosts)
        jds = jdataset.PatchDataset(folder, samples_per_song=3,
                                    input_len=128)
        j_local = -(-batch_size // hosts)
        j_steps = -(-len(jds) // (j_local * hosts))
        full = jds.file_names
        jds.file_names = jmh.process_shard(full, h, hosts) or [
            full[h % len(full)]]
        assert (local_bs, steps) == (j_local, j_steps)
        assert ds.file_names == jds.file_names
        for ep in (0, 1):
            got = list(ds.index_batches(
                local_bs, seed=tmh.epoch_seed(seed, ep, h), n_steps=steps))
            want = list(jds.index_batches(
                j_local, seed=seed * 100003 + ep + h * 7919,
                n_steps=j_steps))
            assert len(got) == len(want) == steps
            for (gi, gs), (wi, ws) in zip(got, want):
                assert [ds.file_names[i % ds.n_songs] for i in gi] == \
                    [jds.file_names[i % jds.n_songs] for i in wi]
                np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("n_steps", [2, None])
def test_multihost_device_dataset_matches_the_host_and_svs_tpus(
        ranks, songs, n_steps):
    """3 songs over 2 hosts (2 and 1), local batches of 3 padded to 4 (2 a
    rank): each rank's block is ``global_batch_from_local`` of the host
    pipeline's batch, bit for bit, and a host's two blocks are svs_tpu's
    ``MultiHostDeviceDataset`` over its shard on a 2-device mesh; with
    ``n_steps`` two full batches, without it the epoch's ragged tail."""
    cfg = dict(FIT, samples_per_song=2)
    out = ranks.run(M.device_blocks, songs, cfg, 3, n_steps)
    jm = jmesh.make_mesh(2)
    for h in (0, 1):
        jds = jdataset.PatchDataset(songs, samples_per_song=2,
                                    input_len=128)
        jds.file_names = jmh.process_shard(jds.file_names, h, 2)
        want = list(jdd.MultiHostDeviceDataset(jds, jm, 4).batches(
            3, seed=dryrun.MH_SEED, n_steps=n_steps))
        (b0, c0, nb0), (b1, c1, nb1) = out[2 * h], out[2 * h + 1]
        for c in (c0, c1):
            assert c["equal"], c
            assert c["songs"] == (2 if h == 0 else 1)
        assert c0["rows"] == ([3, 3] if n_steps else
                              ([3, 1] if h == 0 else [2]))
        assert len(b0) == len(b1) == len(want)
        for g0, g1, w in zip(b0, b1, want):
            for k in PLANES + ("weight",):
                np.testing.assert_array_equal(
                    np.concatenate([g0[k], g1[k]]), np.asarray(w[k]),
                    err_msg=k)
        assert nb0 == nb1 == jdd.resident_bytes(jds)


def _aug_batch(rows, n_real):
    """tests/test_augment.py's draws: complex mixtures as magnitude and
    angle planes, rows past ``n_real`` zero with zero weight."""
    rng = np.random.default_rng(5)
    shape = (rows, 16, 8)
    mix_c = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    voc_c = 0.5 * (rng.standard_normal(shape)
                   + 1j * rng.standard_normal(shape))
    mix_c = mix_c + voc_c
    w = np.asarray([1.0] * n_real + [0.0] * (rows - n_real), np.float32)
    out = {"mix": np.abs(mix_c), "mix_angle": np.angle(mix_c),
           "voc": np.abs(voc_c), "voc_angle": np.angle(voc_c)}
    out = {k: (v * w[:, None, None]).astype(np.float32)
           for k, v in out.items()}
    out["weight"] = w
    return out


@pytest.mark.parametrize("n_real", [1, 3, 4])
def test_apply_sharded_matches_svs_tpus(ranks, n_real):
    """A host batch of 4 rows over a host's 2 ranks (2 a shard): rank
    ``r``'s rows are svs_tpu's shard ``r`` of ``apply_sharded`` on the
    2-device mesh at the same epoch seed and ``n_real`` (n_real 1: shard 1
    fully padded, returned untouched), the generators at one point after
    it, and the numpy oracle within svs_tpu's bound."""
    batch = _aug_batch(4, n_real)
    jm = jmesh.make_mesh(2)
    sh = NamedSharding(jm, P("data"))
    jaug = jaugment.Augmenter(remix_p=0.8).for_epoch(dryrun.MH_SEED)
    want = jaug.apply_sharded({k: jax.device_put(v, sh)
                               for k, v in batch.items()}, n_real=n_real)
    next_draw = float(jaug._rng.uniform())
    out = ranks.run(M.apply_sharded, batch, n_real)
    for rank, (got, draw, check) in enumerate(out):
        lo = (rank % 2) * 2
        assert draw == next_draw
        assert check["in_step"] and check["pads_zero"] and \
            check["untouched"], check
        assert max(check["max_err"].values()) <= 1e-5, check
        for k in ("mix", "mix_angle", "voc", "voc_angle"):
            w = np.asarray(want[k])[lo:lo + 2]
            if n_real <= lo:
                np.testing.assert_array_equal(got[k], w, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6,
                                           err_msg=k)
        np.testing.assert_array_equal(got["weight"], batch["weight"][
            lo:lo + 2])


def _fit(ranks, kind, out, stop=None, load_paths=None, **kw):
    res = ranks.run(M.fit, kind, _opts(out[0], out[1], **kw), FIT,
                    stop=stop, load_paths=load_paths)
    return [r for r in res if r is not None]


@pytest.fixture(scope="module")
def two_host_fit(ranks, songs, tmp_path_factory):
    """The uninterrupted two-host fit (host pipeline): batch 5 over 2
    hosts of one rank, 3 a host, one step an epoch, two epochs."""
    out = str(tmp_path_factory.mktemp("mh_fit"))
    with _one_thread():
        res = _fit(ranks, "hosts", (songs, out), batch_size=5,
                   device_data="off")
    return out, res


def test_two_host_fit_runs_in_lockstep_and_writes_once(ranks, songs,
                                                       two_host_fit,
                                                       tmp_path):
    """Both hosts take the same steps and hold the same bits; rank 0 alone
    writes (one log line an epoch and a validation); the songs on the
    device give the host pipeline's bits."""
    out, (r0, r1) = two_host_fit
    assert r0["code"] == r1["code"] == 0
    assert r0["steps"] == r1["steps"] == 2  # ceil(6 / (3 * 2)) an epoch
    assert r1["written"] == []
    assert sorted(set(r0["written"])) == ["svs_best_t.ckpt", "svs_t.ckpt",
                                          "svs_t_400.ckpt"]
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k],
                                      err_msg=k)
    lines = _lines(out, "log_t.txt")
    assert len(lines) == 4 and lines[1].startswith("Val ")
    metrics = [json.loads(x) for x in _lines(out, "metrics_t.jsonl")]
    assert [m.get("steps") for m in metrics] == [1, None, 1, None]
    d0, d1 = _fit(ranks, "hosts", (songs, str(tmp_path)), batch_size=5,
                  device_data="on")
    assert d0["steps"] == d1["steps"] == 2
    for k in r0["state"]:
        np.testing.assert_array_equal(d0["state"][k], r0["state"][k],
                                      err_msg=k)
    assert _lines(str(tmp_path), "log_t.txt") == lines


def test_two_host_cp_fit_is_the_one_host_cp_fit(ranks, songs, tmp_path):
    """CP keeps the songs whole and the seed unmixed: two hosts of one
    rank train an epoch as one host of two ranks, bit for bit."""
    got, want = (_fit(ranks, kind, (songs, str(tmp_path / kind)),
                      batch_size=3, epoch=1, parallel="cp")
                 for kind in ("hosts", "one"))
    assert [r["steps"] for r in got + want] == [2, 2, 2, 2]
    for k in want[0]["state"]:
        for r in got:
            np.testing.assert_array_equal(r["state"][k], want[0]["state"][k],
                                          err_msg=k)
    assert _lines(str(tmp_path / "hosts"), "log_t.txt") == \
        _lines(str(tmp_path / "one"), "log_t.txt")


@pytest.fixture(scope="module")
def world_fit(ranks, songs, tmp_path_factory):
    """One epoch of the two-host DP fit over the whole pool (two hosts of
    two ranks): batch 5, 3 rows a host padded to 4, 2 a rank."""
    out = str(tmp_path_factory.mktemp("mh_world"))
    with _one_thread():
        res = ranks.run(M.fit_world, _opts(songs, out, batch_size=5,
                                           epoch=1), FIT)
    return out, res


@pytest.mark.parametrize("layout", ["zero1", "fsdp", "tp"])
def test_two_host_sharded_and_tp_fits_match_the_dp_fit(ranks, songs,
                                                       world_fit, tmp_path,
                                                       layout):
    """Two hosts of two ranks: ZeRO-1 gives the two-host DP fit's bits (the
    same step and gradient all-reduce, Adam's moments cut over the
    ranks); FSDP (its gradient summed leaf by leaf, which gloo orders
    otherwise over four ranks, one host or two) and TP on the (2, 2) mesh,
    a data row a host, their per-epoch losses within tests/test_torch_dp.py's
    fit bounds (train 1e-4, validation 1e-3 relative); every rank the same
    gathered state."""
    out = str(tmp_path)
    kw = (dict(parallel="tp") if layout == "tp" else {layout: True})
    got = ranks.run(M.fit_world, _opts(songs, out, batch_size=5, epoch=1,
                                       **kw), FIT,
                    shape=(2, 2) if layout == "tp" else None)
    want_out, want = world_fit
    assert [r["steps"] for r in got] == [r["steps"] for r in want] == [1] * 4
    assert [r["written"] != [] for r in got] == [True, False, False, False]
    for r in got[1:]:
        for k in got[0]["state"]:
            np.testing.assert_array_equal(r["state"][k], got[0]["state"][k],
                                          err_msg=k)
    if layout == "zero1":
        for k in want[0]["state"]:
            np.testing.assert_array_equal(got[0]["state"][k],
                                          want[0]["state"][k], err_msg=k)
        assert _lines(out, "log_t.txt") == _lines(want_out, "log_t.txt")
        return
    for a, b in zip(_lines(out, "log_t.txt"), _lines(want_out, "log_t.txt")):
        assert a.startswith("Val ") == b.startswith("Val ")
        np.testing.assert_allclose(float(a.split()[-1]), float(b.split()[-1]),
                                   rtol=1e-3 if a.startswith("Val ")
                                   else 1e-4)


def _same_resumed(got, want):
    """A resumed run's state dict against the uninterrupted run's, bit for
    bit, but BatchNorm's batch counters, which a ``.ckpt`` does not hold
    (svs_tpu's state has none) and the momentum BatchNorm never reads."""
    for k in want:
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sigterm_on_one_host_stops_both_and_the_resume_is_exact(
        ranks, songs, two_host_fit, tmp_path):
    """Host 1 alone takes a SIGTERM after its first step: the flag is
    agreed at the epoch's end, both exit 143 there and rank 0 saves; the
    resume finishes the uninterrupted run's bits."""
    out = str(tmp_path)
    r0, r1 = _fit(ranks, "hosts", (songs, out), stop=(1, 1), batch_size=5,
                  device_data="off")
    assert r0["code"] == r1["code"] == 143
    assert r0["steps"] == r1["steps"] == 1
    assert r1["written"] == [] and "svs_t.ckpt" in r0["written"]
    ckpt = os.path.join(out, "CKPT", "svs_t.ckpt")
    resumed = _fit(ranks, "hosts", (songs, out), batch_size=5,
                   device_data="off", load_path=ckpt)
    _, want = two_host_fit
    for r in resumed:
        assert r["code"] == 0 and r["steps"] == 1
        _same_resumed(r["state"], want[0]["state"])


def test_a_host_without_the_checkpoint_takes_rank_0s(ranks, songs,
                                                     two_host_fit, tmp_path):
    """Host 0 resumes from epoch 1 of the uninterrupted run, host 1 finds
    no file: ``sync_resume`` gives it host 0's state, and both finish the
    uninterrupted run's bits."""
    out = str(tmp_path)
    first = _fit(ranks, "hosts", (songs, out), batch_size=5, epoch=1,
                 device_data="off")
    assert [r["code"] for r in first] == [0, 0]
    ckpt = os.path.join(out, "CKPT", "svs_t.ckpt")
    resumed = _fit(ranks, "hosts", (songs, out), batch_size=5,
                   device_data="off",
                   load_paths=[ckpt, os.path.join(out, "missing.ckpt")])
    _, want = two_host_fit
    for r in resumed:
        assert r["code"] == 0 and r["steps"] == 1
        _same_resumed(r["state"], want[0]["state"])


def test_sync_resume_broadcasts_rank_0s_state(ranks):
    """Host 1's ranks hold a fresh state at epoch 0, host 0's a stepped
    one at epoch 3: every rank ends with host 0's parameters, BN
    statistics, Adam moments, step, learning rate, epoch and extras."""
    cfg = dict(NARROW, mr_mag_impl="fft")
    out = ranks.run(M.sync, cfg, _batch(3, 2), False)
    for r in out:
        assert r["epoch"] == 3 and r["step"] == 1
        assert r["extras"] == {"best_val_loss": 0.5,
                               "loss_list_total": [3.0, 2.0, 1.0]}
        assert (r["digest"], r["moments"]) == r["want"]
        assert r["lr"] == out[0]["lr"]


def test_sync_resume_raises_where_a_host_is_ahead_of_rank_0(ranks):
    cfg = dict(NARROW, mr_mag_impl="fft")
    for r in ranks.run(M.sync, cfg, _batch(3, 2), True):
        assert "resume desync: process 0 resumed at epoch 2" in r["error"]


def test_assert_scalar_agreement_raises_on_a_spread(ranks):
    assert ranks.run(M.agreement, [1.5] * 4) == [None] * 4
    for said in ranks.run(M.agreement, [1.5, 1.5, 1.5, 1.5 + 1e-7]):
        assert said.startswith("cross-host disagreement on avg_val_loss")
    assert ranks.run(M.agreement, [1.5, 1.5, 1.5, 1.5 + 1e-7], 1e-6) == \
        [None] * 4
    for said in ranks.run(M.agreement, [1.5, float("nan"), 1.5, 1.5], 1.0):
        assert "hosts would desync" in said


def test_fit_keeps_svs_tpus_multihost_refusals(songs, tmp_path):
    """``val_sdr`` and ``epoch_scan`` across hosts, and a TP mesh whose
    model group spans two hosts (checked before any collective)."""
    two = _fake(0, 2, 2)
    base = _opts(songs, str(tmp_path))
    for kw, says in ((dict(mesh=two, val_sdr=True), "single-process run"),
                     (dict(mesh=two, epoch_scan=True), "not cp/tp/zero1"),
                     (dict(mesh=tmesh.Mesh2D(
                         None, 0, 2, torch.device("cpu"), hosts=2,
                         data=_fake(0, 1, 1), model=_fake(0, 2, 1)),
                         parallel="tp"), "'model' axis crosses hosts")):
        with pytest.raises(ValueError, match=says):
            tloop.fit(tloop.TrainOptions(**dict(base, device="cpu", **kw)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_coordinator_trains_two_hosts(songs, tmp_path):
    """``train_cli --coordinator 127.0.0.1:PORT --num_hosts 2 --host_id I
    --dp`` as two processes, one rank a host: the default preset's full
    width, float32, one step of one row a host and a validation pass;
    host 0 prints the host line and writes."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "GROUP_RANK",
              "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "svs_torch.cli.train_cli", "--label", "c",
         "--train_folder", songs, "--valid_folder", songs, "--load_path",
         str(tmp_path / "none.ckpt"), "--epoch", "1", "--val_interval", "1",
         "--batch_size", "2", "--samples_per_song", "1", "--dtype",
         "float32", "--ckpt_dir", str(tmp_path / "CKPT"), "--log_dir",
         str(tmp_path / "LOG"), "--dp", "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num_hosts", "2",
         "--host_id", str(h)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for h in (0, 1)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "[svs-torch] multi-host: host 0/2, 1 local of 2 ranks" in outs[0]
    assert "multi-host" not in outs[1]
    lines = _lines(str(tmp_path), "log_c.txt")
    assert len(lines) == 2 and lines[1].startswith("Val ")
    assert all(np.isfinite(float(x.split()[-1])) for x in lines)
    assert sorted(os.listdir(tmp_path / "CKPT")) == ["svs_best_c.ckpt",
                                                     "svs_c.ckpt"]

"""The port's data-parallel layer (``svs_torch.parallel``: ``mesh``, ``dp``,
``separate_magnitude_mesh``, the mesh ``DeviceDataset``, ``fit`` with a
mesh, ``train_cli --dp``, ``infer_cli --sp``) on two gloo ranks on the CPU.

The module starts its ranks once (a ``launch.Ranks`` pool, one thread a
rank) and runs every case through them; what they run is in
``tests/torch_dp_workers.py``, which imports no JAX.  Bounds:

- the DP step on 2 ranks against svs_tpu's ``make_dp_train_step`` on the
  2-device virtual mesh, float32, the narrow U-Net at 128 frames, dropout
  off, under ``fft`` and the plain version of ``pallas_fused`` (the Pallas
  kernel in interpret mode there), for an even batch and for B = 3, whose
  pad row has weight 0: loss <= 1e-5 relative, the all-reduced gradient
  <= 1e-5 relative L2 (1.4e-6 to 4.0e-6 observed), BN running statistics
  <= 1e-5 absolute; the ranks' gradients the same bits;
- the port against itself: at world size 2 with dropout 0.5 the DP step is
  the single-process step of the same global batch and generator within
  ``__graft_entry__``'s envelope (``dryrun.ENVELOPE``), and both ranks hold
  the same bits after two steps; at world size 1 the DP step is the
  single-device step bit for bit;
- ``separate_magnitude_mesh`` on 2 ranks against svs_tpu's on 2 devices
  in both modes, both ways of ``vocal_solo``, at the edge lengths of
  tests/test_infer_mesh.py: atol 2e-5;
- a 2-rank ``fit`` (the dataset on the device and on the host) writes rank
  0's files only, and its per-epoch losses are the single-device fit's
  within tests/test_torch_fit.py's bounds for one f32 implementation
  against another (train 1e-4, validation 1e-3 relative); a SIGTERM on one
  rank stops both at the same step with 143.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp
import optax

import torch_dp_workers as W
from svs_torch.cli import infer_cli, train_cli
from svs_torch.data import device_data as tdd
from svs_torch.data.augment import Augmenter
from svs_torch.data.dataset import PatchDataset
from svs_torch.infer import separate as tsep
from svs_torch.models import torch_import as t_import
from svs_torch.parallel import dryrun
from svs_torch.parallel import mesh as tmesh
from svs_torch.parallel.launch import Ranks
from svs_torch.train import loop as tloop
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_torch.utils.config import get_config
from svs_tpu.infer import separate as jsep
from svs_tpu.ops.pallas import fused_loss as jfl
from svs_tpu.parallel import dp as jdp
from svs_tpu.parallel import mesh as jmesh
from svs_tpu.parallel import multihost as jmultihost
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

HERE = os.path.dirname(os.path.abspath(__file__))
NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), dropout_rate=0.0,
              input_len=128)
FIT = dict(NARROW, mr_mag_impl="fft", samples_per_song=2, lr_drop_epoch=1,
           lr_after_drop=5e-4)


def _one_thread():
    """One OpenMP thread (torch's intra-op pool) in this process, restored
    on exit (the ranks have one each): Tier-1 runs six test files at once.
    Through threadpoolctl: ``torch.set_num_threads`` also sets MKL's
    count, after which MKL's float64 solve in ``bss_torch`` hangs."""
    return threadpoolctl.threadpool_limits(1, user_api="openmp")


@pytest.fixture(autouse=True)
def one_thread():
    with _one_thread():
        yield


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks(2, timeout=600)
    yield pool
    pool.close()


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


def _fake(rank, size=2):
    """A rank's view for the host-side distributors, which call no
    collective."""
    return tmesh.Mesh(None, rank, size, torch.device("cpu"))


# the gradient's optimiser: no update, and the state is the gradient
_GRAB = optax.GradientTransformation(
    lambda p: p, lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("impl,b", [("fft", 2), ("fft", 3),
                                    ("pallas_fused", 3)])
def test_dp_step_matches_svs_tpus(ranks, impl, b):
    cfg = dict(NARROW, mr_mag_impl=impl)
    jcfg = JConfig(**cfg)
    mesh = jmesh.make_mesh(2)
    state = jstep.create_train_state(jax.random.key(0), jcfg, _GRAB)
    start = _sd(state.params, state.bn_state)  # the step donates the state
    batch = _batch(b, b)
    jfl._INTERPRET = True
    try:
        step = jdp.make_dp_train_step(mesh, jcfg, _GRAB)
        jstate, jaux = step(jdp.replicate_state(state, mesh),
                            jmesh.shard_batch(mesh, batch),
                            jax.random.key(1))
        jaux = {k: float(v) for k, v in jaux.items()}
    finally:
        jfl._INTERPRET = False
    want = _sd(jstate.opt_state, jstate.bn_state)  # the gradient, by name
    (m0, g0, bn0), (m1, g1, bn1) = ranks.run(W.dp_grads, cfg, start, batch)
    assert m0 == m1
    for k in ("l1", "mr", "total"):
        assert abs(m0[k] - jaux[k]) <= 1e-5 * abs(jaux[k]), k
    assert set(g0) == set(want) - {k for k in want if "running" in k
                                   or "num_batches" in k}
    num = sum(float(((g0[k] - want[k]) ** 2).sum()) for k in g0)
    den = sum(float((want[k] ** 2).sum()) for k in g0)
    assert np.sqrt(num / den) <= 1e-5
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k])
    for k in bn0:
        np.testing.assert_allclose(bn0[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_array_equal(bn0[k], bn1[k])


def test_dp_step_at_world_2_is_the_single_process_step(ranks):
    """Dropout 0.5, two steps of B = 4: the masks are drawn at the global
    batch's shape, so the DP step is the single-process step up to sum
    order; both ranks hold the same bits."""
    cfg = dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5)
    batches = [_batch(10, 4), _batch(11, 4)]
    (m0, states0), (m1, states1) = ranks.run(W.dp_steps, cfg, batches)
    assert m0 == m1
    for k in states0[1]:
        np.testing.assert_array_equal(states0[1][k], states1[1][k],
                                      err_msg=k)

    tcfg = TConfig(**cfg)
    state = tstep.create_train_state(0, tcfg, device="cpu")
    step = tstep.make_train_step(tcfg)
    gen = torch.Generator().manual_seed(1)
    state, ref = step(state, tstep.batch_to_device(batches[0], "cpu"), gen)
    got_state = tstep.create_train_state(0, tcfg, device="cpu")
    got_state.model.load_state_dict({k: torch.from_numpy(v)
                                     for k, v in states0[0].items()})
    out = dryrun.envelope({k: torch.tensor(v) for k, v in m0[0].items()},
                          got_state, ref, state, tcfg.learning_rate)
    assert out["ok"], out


def test_dp_step_at_world_1_is_the_single_device_step(ranks):
    """Rank 0 in a group of its own: two DP steps with dropout are the
    single-device steps, bit for bit."""
    cfg = dict(NARROW, mr_mag_impl="pallas_fused", dropout_rate=0.5)
    out = ranks.run(W.world_of_one, cfg, [_batch(20, 3), _batch(21, 3)])
    assert out[1] is None
    (dp_m, dp_sd), (one_m, one_sd) = out[0]
    assert dp_m == one_m
    for k in one_sd:
        np.testing.assert_array_equal(dp_sd[k], one_sd[k], err_msg=k)


def test_dp_eval_step_is_the_global_weighted_mean(ranks):
    """B = 3 padded to the batch size 4 on 2 ranks: the single-device eval
    step's metrics (sum order apart)."""
    tcfg = TConfig(**dict(NARROW, mr_mag_impl="fft"))
    state = tstep.create_train_state(0, tcfg, device="cpu")
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    batch = _batch(30, 3)
    got = ranks.run(W.dp_eval, dict(NARROW, mr_mag_impl="fft"), sd, batch, 4)
    assert got[0] == got[1]
    want = tstep.make_eval_step(tcfg)(state,
                                      tstep.batch_to_device(batch, "cpu"))
    for k in ("l1", "mr", "total"):
        np.testing.assert_allclose(got[0][k], float(want[k]), rtol=1e-5)


@pytest.mark.parametrize("b,pad_rows_to", [(3, None), (4, None), (3, 4),
                                           (3, 5)])
def test_distributors_match_svs_tpus(b, pad_rows_to):
    """``shard_batch`` (pad_rows_to None) and ``global_batch_from_global``:
    the ranks' blocks put together are svs_tpu's global arrays on the
    2-device mesh, the weight included."""
    mesh = jmesh.make_mesh(2)
    batch = _batch(40, b, t=64)
    if pad_rows_to is None:
        want = jmesh.shard_batch(mesh, batch)
        got = [tmesh.shard_batch(_fake(r), batch) for r in (0, 1)]
    else:
        want = jmultihost.global_batch_from_global(mesh, batch,
                                                   pad_rows_to=pad_rows_to)
        got = [tmesh.global_batch_from_global(_fake(r), batch, pad_rows_to)
               for r in (0, 1)]
    assert sorted(got[0]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(
            torch.cat([g[k] for g in got]).numpy(), np.asarray(v), err_msg=k)


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


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    return _songs(str(tmp_path_factory.mktemp("dp_songs")))


@pytest.mark.parametrize("augment", [False, True])
def test_mesh_device_dataset_is_the_host_batch_sharded(songs, augment):
    """Each rank's step inputs as ``fit`` makes them from the mesh
    dataset's batches (remixed whole with ``augment``, then cut by
    ``shard_batch``) are the host pipeline's, bit for bit; so are the
    validation tail's, padded by ``global_batch_from_global``."""
    host = PatchDataset(songs, samples_per_song=5, input_len=128)
    for r in (0, 1):
        ds = tdd.DeviceDataset(host, mesh=_fake(r))
        aug_d = Augmenter().for_epoch(3) if augment else None
        aug_h = Augmenter().for_epoch(3) if augment else None
        got = list(ds.batches(3, seed=7))
        for g, h in zip(got, host.batches(3, seed=7)):
            h = tstep.batch_to_device(h, "cpu")
            if augment:
                g, h = aug_d(g), aug_h(h)
            g, want = tmesh.shard_batch(_fake(r), g), tmesh.shard_batch(
                _fake(r), h)
            assert sorted(g) == sorted(want)
            for k in want:
                assert torch.equal(g[k], want[k]), k
        assert len(got) == 4  # 10 patches: three of 3 and a tail of 1
        val = tmesh.global_batch_from_global(
            _fake(r), list(ds.batches(3, shuffle=False, seed=0))[-1], 3)
        want = tmesh.global_batch_from_global(
            _fake(r), tstep.batch_to_device(
                list(host.batches(3, shuffle=False, seed=0))[-1], "cpu"), 3)
        for k in want:
            assert torch.equal(val[k], want[k]), k


@pytest.mark.parametrize("mode", ["segments", "overlap"])
@pytest.mark.parametrize("vocal_solo", [True, False])
def test_sp_decode_matches_svs_tpus(ranks, mode, vocal_solo):
    """At tests/test_infer_mesh.py's edge lengths: the window-count
    bucketing to lcm(2, 8) changes no value."""
    cfg = dict(NARROW, input_len=64)
    jcfg = JConfig(**cfg)
    state = jstep.create_train_state(jax.random.key(0), jcfg)
    mesh = jmesh.make_mesh(2)
    mags = [np.abs(np.random.default_rng(t).standard_normal(
        (513, t))).astype(np.float32) for t in (1, 63, 64, 65, 200, 513)]
    got = ranks.run(W.sp_decode, cfg, _sd(state.params, state.bn_state),
                    [(m, mode, vocal_solo) for m in mags])
    assert got[1] == [None] * len(mags)
    for mag, g in zip(mags, got[0]):
        want = jsep.separate_magnitude_mesh(
            state.params, state.bn_state, mag, mesh, cfg=jcfg, mode=mode,
            vocal_solo=vocal_solo)
        assert g.shape == want.shape == mag.shape
        np.testing.assert_allclose(g, want, atol=2e-5,
                                   err_msg=f"t={mag.shape[1]}")


def test_sp_whole_mode_is_not_ported():
    model = tstep.create_train_state(0, TConfig(**NARROW),
                                     device="cpu").model.eval()
    mag = np.ones((513, 64), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP A.10.6"):
        tsep.separate_magnitude_mesh(model, mag, _fake(0), mode="whole")
    with pytest.raises(ValueError, match="unknown mode"):
        tsep.separate_magnitude_mesh(model, mag, _fake(0), mode="nope")


def _opts(songs, out, **kw):
    base = dict(train_folder=songs, valid_folder=songs, load_path="none",
                label="t", epoch=2, batch_size=3, val_interval=1,
                ckpt_dir=os.path.join(out, "CKPT"),
                log_dir=os.path.join(out, "LOG"), progress=False)
    base.update(kw)
    return base


def _lines(out, name):
    with open(os.path.join(out, "LOG", name)) as f:
        return f.read().splitlines()


@pytest.fixture(scope="module")
def single_fit(songs, tmp_path_factory):
    """The single-device fit that the 2-rank fits are held against."""
    out = str(tmp_path_factory.mktemp("single"))
    with _one_thread():
        state = tloop.fit(tloop.TrainOptions(**_opts(songs, out),
                                             device="cpu"), TConfig(**FIT))
    return out, state


@pytest.mark.parametrize("device_data", ["on", "off"])
def test_two_rank_fit_is_the_single_device_fit(ranks, songs, single_fit,
                                               tmp_path, device_data):
    """Two epochs of a full batch of 3 and a tail of 1 (padded on rank 1),
    validation each epoch, across the learning-rate drop."""
    out = str(tmp_path)
    r0, r1 = ranks.run(W.fit, _opts(songs, out, device_data=device_data),
                       FIT)
    assert r0["code"] == r1["code"] == 0
    assert r0["steps"] == r1["steps"] == 4
    assert sorted(r0["written"]) == ["svs_best_t.ckpt", "svs_best_t.ckpt",
                                     "svs_t.ckpt", "svs_t.ckpt",
                                     "svs_t_400.ckpt"] \
        or sorted(r0["written"]) == ["svs_best_t.ckpt", "svs_t.ckpt",
                                     "svs_t.ckpt", "svs_t_400.ckpt"]
    assert r1["written"] == []
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k],
                                      err_msg=k)
    # one writer: one line per epoch and per validation
    want_out, _ = single_fit
    got, want = _lines(out, "log_t.txt"), _lines(want_out, "log_t.txt")
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.startswith("Val ") == b.startswith("Val ")
        np.testing.assert_allclose(float(a.split()[-1]), float(b.split()[-1]),
                                   rtol=1e-3 if a.startswith("Val ")
                                   else 1e-4)
    metrics = [json.loads(x) for x in _lines(out, "metrics_t.jsonl")]
    assert [m.get("steps") for m in metrics] == [2, None, 2, None]
    assert sorted(os.listdir(os.path.join(out, "CKPT"))) == [
        "svs_best_t.ckpt", "svs_t.ckpt", "svs_t_400.ckpt"]


def test_sigterm_on_one_rank_stops_both_at_one_step(ranks, songs, tmp_path):
    """Rank 1 alone takes a SIGTERM after its first step: the flag is
    agreed there, both ranks exit 143 after that step, rank 0 saves, and a
    resume from its checkpoint finishes the run."""
    out = str(tmp_path)
    opts = _opts(songs, out, valid_folder="none")
    r0, r1 = ranks.run(W.fit, opts, FIT, stop=(1, 1))
    assert r0["code"] == r1["code"] == 143
    assert r0["steps"] == r1["steps"] == 1
    assert r0["written"] == ["svs_t.ckpt"] and r1["written"] == []
    from svs_torch.train import flax_msgpack as fm
    with open(os.path.join(out, "CKPT", "svs_t.ckpt"), "rb") as f:
        saved = fm.unpackb(f.read())
    assert (saved["epoch"], saved["step"]) == (0, 1)
    resumed = ranks.run(W.fit, dict(opts, load_path=os.path.join(
        out, "CKPT", "svs_t.ckpt")), FIT)
    assert [r["code"] for r in resumed] == [0, 0]
    assert [r["steps"] for r in resumed] == [4, 4]
    assert len(_lines(out, "log_t.txt")) == 2


def test_train_cli_dp_trains_on_two_ranks(ranks, songs, tmp_path):
    """``train_cli --dp`` at the default preset's full width, float32, one
    step of 2 (a row a rank) and a validation pass; rank 0 writes."""
    argv = ["--label", "c", "--train_folder", songs, "--valid_folder",
            songs, "--load_path", str(tmp_path / "none.ckpt"), "--epoch",
            "1", "--val_interval", "1", "--batch_size", "2",
            "--samples_per_song", "1", "--dtype", "float32", "--ckpt_dir",
            str(tmp_path / "CKPT"), "--log_dir", str(tmp_path / "LOG"),
            "--augment", "--dp", "--device", "cpu"]
    assert ranks.run(W.cli, "train_cli", argv) == [0, 0]
    lines = _lines(str(tmp_path), "log_c.txt")
    assert len(lines) == 2 and lines[1].startswith("Val ")
    assert all(np.isfinite(float(x.split()[-1])) for x in lines)
    assert sorted(os.listdir(tmp_path / "CKPT")) == ["svs_best_c.ckpt",
                                                     "svs_c.ckpt"]


def test_infer_cli_sp_decodes_on_two_ranks(ranks, songs, tmp_path):
    """``infer_cli --sp`` writes, from rank 0, what ``infer_cli`` writes
    on one device (atol 2e-5), in both SP modes."""
    cfg = dataclasses.replace(get_config("default"), compute_dtype="float32")
    model = tstep.create_train_state(0, cfg, device="cpu").model
    pth = str(tmp_path / "m.pth")
    t_import.save_pth(pth, model)
    mixture = os.path.join(songs, "mixture")
    for mode in ("segments", "overlap"):
        base = ["--model_path", pth, "--mixture_folder", mixture,
                "--preset", "default", "--dtype", "float32", "--mode", mode,
                "--limit", "1", "--device", "cpu"]
        one, sp = str(tmp_path / f"one_{mode}"), str(tmp_path / f"sp_{mode}")
        assert ranks.run(W.cli, "infer_cli",
                         base + ["--tar", sp, "--sp"]) == [0, 0]
        assert infer_cli.main(base + ["--tar", one]) == 0
        names = sorted(os.listdir(one))
        assert names == sorted(os.listdir(sp)) and len(names) == 1
        for name in names:
            np.testing.assert_allclose(np.load(os.path.join(sp, name)),
                                       np.load(os.path.join(one, name)),
                                       atol=2e-5)


def test_infer_cli_refuses_cp_and_whole_sp(capsys):
    for argv, item in ((["--cp"], "A.10.6"),
                       (["--sp", "--mode", "whole"], "A.10.6")):
        with pytest.raises(SystemExit) as err:
            infer_cli.main(["--model_path", "m", "--tar", "t",
                            "--mixture_folder", "f", "--device", "cpu",
                            *argv])
        assert err.value.code == 2
        assert f"ROADMAP {item}" in capsys.readouterr().err


def test_make_mesh_alone_is_a_world_of_one():
    """Without torchrun's environment: a process group of one rank (gloo on
    the CPU), whose batch-crossing sums are the local ones.  It lives in
    this process and starts no rank; it is destroyed before the next
    case."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        assert mesh.shape == {"data": 1} and mesh.is_primary
        x = torch.arange(3.0, requires_grad=True)
        assert tmesh.all_sum(x, mesh) is x
        assert tmesh.agree(True, mesh) and not tmesh.agree(False, mesh)
        with pytest.raises(ValueError, match="requested 2 ranks"):
            tmesh.make_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="not nccl"):
            tmesh.make_mesh(device="cpu", backend="nccl")
    finally:
        dist.destroy_process_group()


def test_train_cli_epoch_scan_with_dp_is_not_ported(capsys):
    with pytest.raises(SystemExit) as err:
        train_cli.main(["--label", "x", "--device", "cpu", "--dp",
                        "--epoch_scan"])
    assert err.value.code == 2
    assert "ROADMAP A.10.2" in capsys.readouterr().err
    # with ZeRO-1 it stays refused, with svs_tpu's message
    with pytest.raises(SystemExit) as err:
        train_cli.main(["--label", "x", "--device", "cpu", "--dp",
                        "--zero1", "--epoch_scan"])
    assert err.value.code == 2
    assert "not cp/tp/zero1/fsdp" in capsys.readouterr().err

"""The port's whole-epoch training over a data-parallel mesh
(``svs_torch.train.scan.make_epoch_scan(mesh=...)``, ``fit`` with a mesh
and ``epoch_scan``) on gloo ranks on the CPU, where each rank runs the
graph's per-step body eagerly.

The module starts its ranks once (a ``launch.Ranks`` pool of 4, one thread
a rank; the 2-rank cases run on its first two) and runs every case through
them; what they run is in ``tests/torch_scan_workers.py``, which imports no
JAX.  Bounds:

- against ``svs_tpu.train.scan.make_epoch_scan(mesh=make_mesh(2))`` on two
  of the virtual CPU devices, the same weights and index matrices: the
  narrow U-Net, float32, the exact ``fft`` loss, dropout off, B = 3 (one
  weight-0 pad row on rank 1), three steps.  The per-step losses within
  1e-4 relative and the parameters within ``__graft_entry__.py``'s
  envelope taken once a step (max |d| <= 3 * 2.1 lr, mean |d| < 3 *
  2e-4), tests/test_torch_scan.py's bounds; both ranks the same bits;
- against the port's own per-step DP loop: on the CPU the two run the same
  operations on the same tensors, so a mesh fit with ``epoch_scan`` writes
  the same log, checkpoints and final state, bit for bit, across the
  learning-rate drop and a ragged tail, plain, with accumulation and with
  the remix, on 2 ranks and on 4 ranks where one rank's block is all pad
  rows; a resumed mesh-scan fit equals an uninterrupted one;
- a world of one: the mesh epoch is the single-device epoch of the same
  batches with the all-ones ``weight`` that ``mesh.shard_batch`` appends,
  bit for bit (the unweighted step rounds its means differently);
- what is refused, before any step: svs_tpu's layouts (TP, CP, PP,
  ZeRO-1, FSDP, several hosts, a host dataset) in its words, and gloo
  ranks on a CUDA device, checked before any CUDA call.
"""

import contextlib
import os

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import torch_scan_workers as W
from svs_torch.data import device_data as tdd
from svs_torch.data.dataset import PatchDataset as TPatchDataset
from svs_torch.models import torch_import as t_import
from svs_torch.parallel import pp as tpp
from svs_torch.parallel.launch import Ranks
from svs_torch.parallel.mesh import Mesh, Mesh2D
from svs_torch.train import checkpoint as ckpt_lib
from svs_torch.train import loop as tloop
from svs_torch.train import scan as tscan
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.data import device_data as jdd
from svs_tpu.data.dataset import PatchDataset as JPatchDataset
from svs_tpu.parallel import mesh as jmesh
from svs_tpu.train import scan as jscan
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

# 2 songs x 5 patches at B = 3: three full steps and a tail of one
NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), dropout_rate=0.0,
              mr_mag_impl="fft", samples_per_song=5, input_len=128,
              lr_drop_epoch=1, lr_after_drop=5e-4)
B = 3


@pytest.fixture(autouse=True)
def one_thread():
    """One OpenMP thread in this process while a case runs (the ranks have
    one each): Tier-1 runs six test files at once.  Through threadpoolctl:
    ``torch.set_num_threads`` also sets MKL's count, after which MKL's
    float64 solve in ``bss_torch`` hangs."""
    with threadpoolctl.threadpool_limits(1, user_api="openmp"):
        yield


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks(4, timeout=600)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scan_mesh"))
    rng = np.random.default_rng(0)
    for folder in ("mixture", "vocal"):
        os.makedirs(os.path.join(root, folder))
    for i, t in enumerate((200, 160)):
        for folder in ("mixture", "vocal"):
            np.save(os.path.join(root, folder, f"{i:04d}_s{i}_spec.npy"),
                    rng.random((513, t)).astype(np.float32))
            ang = rng.uniform(-3, 3, (513, t)).astype(np.float32)
            np.save(os.path.join(root, folder, f"{i:04d}_s{i}_phase.npy"),
                    np.exp(1j * ang).astype(np.complex64))
    return root


def _sd(jstate):
    return {k: v.numpy() for k, v in t_import.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state)).items()}


def test_mesh_epoch_matches_svs_tpus_mesh_scan(ranks, songs):
    jcfg = JConfig(**NARROW)
    jopt = jstep.make_optimizer(jcfg)
    jstate = jstep.create_train_state(jax.random.key(0), jcfg, jopt)
    start = _sd(jstate)  # the epoch donates the state
    host = TPatchDataset(songs, samples_per_song=5, input_len=128)
    s, st, tail = tdd.epoch_index_arrays(host, B, shuffle=True, seed=7)
    assert s.shape == (3, B) and tail is not None
    jds = jdd.DeviceDataset(JPatchDataset(songs, samples_per_song=5,
                                          input_len=128))
    jstate, _, jlosses = jscan.make_epoch_scan(
        jcfg, jopt, mesh=jmesh.make_mesh(2))(
        jstate, jds.planes, jnp.asarray(s), jnp.asarray(st),
        jax.random.key(1))
    out = ranks.run(W.epoch, 2, NARROW, start, songs, s, st, 1)
    assert out[2:] == [None, None]
    (l0, n0, s0), (l1, n1, s1) = out[:2]
    assert n0 == n1 == int(jstate.step) == 3
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_allclose(l0, np.asarray(jlosses), rtol=1e-4)
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
    want = _sd(jstate)
    d = np.concatenate([np.abs(s0[k] - w).ravel() for k, w in want.items()
                        if "running" not in k and "num_batches" not in k])
    lr = jcfg.learning_rate
    assert d.max() <= 3 * 2.1 * lr and d.mean() < 3 * 2e-4, (d.max(),
                                                             d.mean())


def _opts(songs, out, **kw):
    base = dict(train_folder=songs, valid_folder="none", load_path="none",
                label="t", epoch=2, batch_size=B, device_data="on",
                ckpt_dir=os.path.join(out, "CKPT"),
                log_dir=os.path.join(out, "LOG"), progress=False)
    base.update(kw)
    return base


def _files(out):
    found = {}
    for sub in ("CKPT", "LOG"):
        for name in sorted(os.listdir(os.path.join(out, sub))):
            with open(os.path.join(out, sub, name), "rb") as f:
                found[name] = f.read()
    return found


def _same(a, b):
    assert (a["step"], a["mini_step"]) == (b["step"], b["mini_step"])
    for k, v in a["state"].items():
        if "num_batches" not in k:  # not in svs_tpu's format, never read
            np.testing.assert_array_equal(b["state"][k], v, err_msg=k)
    assert (a["acc"] is None) == (b["acc"] is None)
    for x, y in zip(a["acc"] or (), b["acc"] or ()):
        np.testing.assert_array_equal(x, y)


def _fits(ranks, songs, tmp_path, n, cfg, **kw):
    """The per-step DP fit and the mesh-scan fit on the first ``n`` ranks:
    rank 0's results of each, after checking that every rank holds its
    bits, and the files each wrote."""
    runs = {}
    for name, scan in (("step", False), ("scan", True)):
        out = str(tmp_path / name)
        got = ranks.run(W.fit, n, _opts(songs, out, epoch_scan=scan, **kw),
                        cfg)
        assert got[n:] == [None] * (4 - n)
        for r in got[1:n]:
            _same(got[0], r)
        runs[name] = (got[0], _files(out))
    return runs


@pytest.mark.parametrize("kw", [
    dict(),
    dict(accum_steps=2),
    dict(augment=True),
], ids=["plain", "accum2", "augment"])
def test_mesh_fit_with_epoch_scan_is_the_per_step_dp_fit(ranks, songs,
                                                         tmp_path, kw):
    """Two ranks, two epochs across the learning-rate drop (at epoch 1),
    three full steps (a pad row on rank 1) and a tail of one (rank 1 all
    pad) an epoch, dropout on: the same bits as the per-step DP loop."""
    runs = _fits(ranks, songs, tmp_path, 2, dict(NARROW, dropout_rate=0.5),
                 **kw)
    (step, want), (scan, got) = runs["step"], runs["scan"]
    _same(step, scan)
    assert sorted(got) == sorted(want) == [
        "log_t.txt", "metrics_t.jsonl", "svs_t.ckpt", "svs_t_400.ckpt"]
    for name in ("log_t.txt", "svs_t.ckpt", "svs_t_400.ckpt"):
        assert got[name] == want[name], name
    lrs = got["metrics_t.jsonl"].decode().splitlines()
    assert '"lr": 0.0005' in lrs[1] and '"steps": 4' in lrs[1]
    if kw.get("accum_steps") == 2:
        # 8 microbatches: the cycle closed at the tail
        assert scan["mini_step"] == 0 and scan["acc"] is None


def test_a_rank_of_pad_rows_only(ranks, songs, tmp_path):
    """B = 3 over 4 ranks: a row a rank and rank 3's block all pad rows
    (weight 0) in every full step; the tail of one leaves three ranks
    padding.  The same bits as the per-step DP loop."""
    runs = _fits(ranks, songs, tmp_path, 4, dict(NARROW, dropout_rate=0.5))
    (step, want), (scan, got) = runs["step"], runs["scan"]
    _same(step, scan)
    assert scan["step"] == 8
    for name in ("log_t.txt", "svs_t.ckpt", "svs_t_400.ckpt"):
        assert got[name] == want[name], name


def test_resumed_mesh_scan_fit_equals_an_uninterrupted_one(ranks, songs,
                                                           tmp_path):
    """Two ranks, both runs from one ``.ckpt`` (a resumed Adam takes the
    file's float32 betas)."""
    init = str(tmp_path / "init.ckpt")
    ckpt_lib.save(init, tstep.create_train_state(0, TConfig(**NARROW),
                                                 device="cpu"))
    full = str(tmp_path / "full")
    half = str(tmp_path / "half")
    want = ranks.run(W.fit, 2, _opts(songs, full, epoch_scan=True,
                                     load_path=init), NARROW)[0]
    ranks.run(W.fit, 2, _opts(songs, half, epoch=1, epoch_scan=True,
                              load_path=init), NARROW)
    got = ranks.run(W.fit, 2, _opts(
        songs, half, epoch_scan=True,
        load_path=os.path.join(half, "CKPT", "svs_t.ckpt")), NARROW)
    _same(want, got[0])
    _same(got[0], got[1])
    assert _files(half)["log_t.txt"] == _files(full)["log_t.txt"]


@pytest.mark.parametrize("augment", [False, True])
def test_world_of_one_is_the_single_device_scan(songs, augment):
    """A mesh of one rank (its sums the local ones) against the
    single-device epoch of the same batches given the all-ones ``weight``
    (``chip_smoke.weighted_single``, which the card's dpscan phase uses
    too): losses and state, bit for bit, dropout on."""
    cfg = TConfig(**dict(NARROW, dropout_rate=0.5))
    host = TPatchDataset(songs, samples_per_song=5, input_len=128)
    s, st, _ = tdd.epoch_index_arrays(host, B, shuffle=True, seed=7)
    planes = tdd.DeviceDataset(host, device="cpu").planes
    aug = ()
    if augment:
        from svs_torch.data.augment import Augmenter
        aug = Augmenter().for_epoch(3).epoch_vectors(len(s), B)
    one = Mesh(None, 0, 1, torch.device("cpu"))
    runs = []
    for mesh in (one, None):
        with (chip_smoke.weighted_single() if mesh is None
              else contextlib.nullcontext()):
            state = tstep.create_train_state(0, cfg, device="cpu")
            state, losses = tscan.make_epoch_scan(cfg, augment, mesh=mesh)(
                state, planes, s, st, torch.Generator().manual_seed(1),
                *aug)
        runs.append((losses, state))
    (l_mesh, s_mesh), (l_one, s_one) = runs
    assert s_mesh.step == s_one.step == 3
    assert torch.equal(l_mesh, l_one)
    theirs = s_one.model.state_dict()
    for k, v in s_mesh.model.state_dict().items():
        assert torch.equal(theirs[k], v), k


def test_mesh_scan_refusals(songs, tmp_path):
    """svs_tpu's layouts in its words; the port's own refusal of gloo
    ranks sharing a card, raised before any CUDA call (this host has no
    card, so any would raise otherwise)."""
    cfg = TConfig(**NARROW)
    one = Mesh(None, 0, 1, torch.device("cpu"))

    def fit(**kw):
        opts = dict(_opts(songs, str(tmp_path), epoch_scan=True), **kw)
        tloop.fit(tloop.TrainOptions(**opts), cfg)

    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tscan.make_epoch_scan(cfg, mesh=object())
    for mesh in (Mesh2D(None, 0, 1, torch.device("cpu"),
                        data=one, model=one),
                 Mesh(None, 0, 2, torch.device("cpu"), hosts=2)):
        with pytest.raises(ValueError, match="not cp/tp/zero1/fsdp"):
            tscan.make_epoch_scan(cfg, mesh=mesh)
    for kw in (dict(mesh=one, zero1=True), dict(mesh=one, fsdp=True),
               dict(mesh=one, parallel="cp"),
               dict(mesh=Mesh2D(None, 0, 1, torch.device("cpu"),
                                data=one, model=one), parallel="tp"),
               dict(mesh=tpp.make_pp_mesh(("cpu", "cpu")), parallel="pp",
                    pp_micro=1),
               dict(mesh=Mesh(None, 0, 2, torch.device("cpu"), hosts=2)),
               dict(mesh=one, device_data="off")):
        with pytest.raises(ValueError, match="not cp/tp/zero1/fsdp"):
            fit(**kw)
    cards = Mesh(None, 0, 2, torch.device("cuda", 0), backend="gloo")
    with pytest.raises(ValueError, match="cannot capture gloo's"):
        tscan.make_epoch_scan(cfg, mesh=cards)
    with pytest.raises(ValueError, match="cannot capture gloo's"):
        fit(mesh=cards, device="cuda")
    # one gloo rank on a card crosses no rank: nothing to refuse
    alone = Mesh(None, 0, 1, torch.device("cuda", 0), backend="gloo")
    assert tscan.make_epoch_scan(cfg, mesh=alone).mesh is alone

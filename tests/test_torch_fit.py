"""The port's training entry point (``svs_torch.train.loop.fit``,
``svs_torch.cli.train_cli``) against svs_tpu's on the CPU, and U-Net remat.

Synthetic ``.npy`` songs, the narrow U-Net (float32, 128-frame patches, no
dropout, the exact ``fft`` loss), and one initial ``.ckpt`` written by
svs_tpu that both fits resume from (their own seeded weights differ).  The
two fits write the same text-log lines (train losses within rtol 1e-4:
one f32 step against another is within 1e-5, tests/test_torch_step.py, and
an epoch's mean over a few steps drifts no further; validation losses
within 1e-3: eval-mode BatchNorm normalises with running statistics that
two steps have barely moved, so the activations are far from unit scale and
amplify the parameters' drift, up to 2 lr where Adam's first update rounds
the sign of a ~0 gradient the other way: 1.2e-4 observed, where the same
eval step on one state agrees to 1e-7), the same
``metrics_*.jsonl`` keys, the same checkpoint trees, and the same
learning-rate schedule across a lowered ``lr_drop_epoch``.  A resumed port
fit equals an uninterrupted one bit for bit (the same data order, Adam
state and learning rate), remat gives the same loss and gradients bit for
bit (it recomputes the same ops), and SIGTERM saves, exits 143 and
resumes.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import threadpoolctl
import torch

import jax

from svs_torch.cli import train_cli
from svs_torch.data.dataset import PatchDataset
from svs_torch.models.unet import UNet
from svs_torch.parallel.mesh import Mesh
from svs_torch.train import flax_msgpack as fm
from svs_torch.train import loop as tloop
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.train import checkpoint as jck
from svs_tpu.train import loop as jloop
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), dropout_rate=0.0,
              mr_mag_impl="fft", samples_per_song=2, input_len=128,
              lr_drop_epoch=1, lr_after_drop=5e-4)


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


def _songs(root, n_songs=2, t=160):
    rng = np.random.default_rng(0)
    for folder in ("mixture", "vocal"):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
    for i in range(n_songs):
        base = f"{i:04d}_s{i}"
        for folder in ("mixture", "vocal"):
            np.save(os.path.join(root, folder, f"{base}_spec.npy"),
                    rng.random((513, t)).astype(np.float32))
            ang = rng.uniform(-3, 3, (513, t)).astype(np.float32)
            np.save(os.path.join(root, folder, f"{base}_phase.npy"),
                    np.exp(1j * ang).astype(np.complex64))
    return root


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Songs and an svs_tpu ``.ckpt`` at epoch 0 that both fits start from."""
    root = tmp_path_factory.mktemp("fit")
    songs = _songs(str(root / "songs"))
    cfg = JConfig(**NARROW)
    init = str(root / "init.ckpt")
    jck.save(init, jstep.create_train_state(jax.random.key(0), cfg), epoch=0)
    return songs, init


def _opts(cls, songs, init, out, **kw):
    base = dict(train_folder=songs, valid_folder=songs, load_path=init,
                label="t", epoch=2, batch_size=2, val_interval=1,
                ckpt_dir=os.path.join(out, "CKPT"),
                log_dir=os.path.join(out, "LOG"), progress=False)
    base.update(kw)
    return cls(**base)


def _port_fit(songs, init, out, **kw):
    return tloop.fit(_opts(tloop.TrainOptions, songs, init, out,
                           device="cpu", **kw), TConfig(**NARROW))


def _lines(out, name):
    with open(os.path.join(out, "LOG", name)) as f:
        return f.read().splitlines()


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return ("array", tree.shape, tree.dtype.name)
    return type(tree).__name__


def test_one_epoch_fit_writes_what_svs_tpu_writes(data, tmp_path):
    songs, init = data
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jloop.fit(_opts(jloop.TrainOptions, songs, init, jout), JConfig(**NARROW))
    state = _port_fit(songs, init, tout)
    assert isinstance(state, tstep.TrainState)

    # the text log: a train loss per epoch, then its Val line
    jlog, tlog = _lines(jout, "log_t.txt"), _lines(tout, "log_t.txt")
    assert len(tlog) == len(jlog) == 4
    for a, b in zip(tlog, jlog):
        assert a.startswith("Val ") == b.startswith("Val ")
        np.testing.assert_allclose(float(a.split()[-1]), float(b.split()[-1]),
                                   rtol=1e-3 if a.startswith("Val ") else 1e-4)
    # metrics: the same records, the same learning rates (dropped at 1)
    jm = [json.loads(x) for x in _lines(jout, "metrics_t.jsonl")]
    tm = [json.loads(x) for x in _lines(tout, "metrics_t.jsonl")]
    assert [sorted(r) for r in tm] == [sorted(r) for r in jm]
    lrs = [r["lr"] for r in tm if "lr" in r]
    np.testing.assert_allclose(lrs, [1e-3, 5e-4], rtol=1e-6)
    np.testing.assert_allclose(lrs, [r["lr"] for r in jm if "lr" in r],
                               rtol=1e-6)
    assert [r.get("steps") for r in tm] == [r.get("steps") for r in jm]
    # the checkpoints: the same files and the same trees
    names = sorted(os.listdir(os.path.join(jout, "CKPT")))
    assert names == sorted(os.listdir(os.path.join(tout, "CKPT"))) == [
        "svs_best_t.ckpt", "svs_t.ckpt", "svs_t_400.ckpt"]
    for name in names:
        trees = []
        for out in (jout, tout):
            with open(os.path.join(out, "CKPT", name), "rb") as f:
                trees.append(fm.unpackb(f.read()))
        assert _shape_tree(trees[1]) == _shape_tree(trees[0]), name
        for k in ("epoch", "step"):
            assert trees[1][k] == trees[0][k], (name, k)
        assert trees[1]["extras"].keys() == trees[0]["extras"].keys()
    best = fm.unpackb(open(os.path.join(tout, "CKPT", "svs_best_t.ckpt"),
                           "rb").read())
    assert best["extras"]["best_val_loss"] == pytest.approx(
        float(tlog[-1].split()[-1]), rel=1e-6) or \
        best["extras"]["best_val_loss"] == pytest.approx(
            float(tlog[1].split()[-1]), rel=1e-6)


def test_resumed_fit_equals_an_uninterrupted_one(data, tmp_path):
    songs, init = data
    full = _port_fit(songs, init, str(tmp_path / "full"))
    half = str(tmp_path / "half")
    _port_fit(songs, init, half, epoch=1)
    resumed = _port_fit(songs, os.path.join(half, "CKPT", "svs_t.ckpt"),
                        half, epoch=2)
    assert resumed.step == full.step
    for k, v in full.model.state_dict().items():
        if "num_batches" not in k:  # not in svs_tpu's format, never read
            assert torch.equal(resumed.model.state_dict()[k], v), k
    assert _lines(half, "log_t.txt") == _lines(str(tmp_path / "full"),
                                              "log_t.txt")
    # the best validation loss came back from the checkpoint
    with open(os.path.join(half, "CKPT", "svs_t.ckpt"), "rb") as f:
        extras = fm.unpackb(f.read())["extras"]
    assert len(extras["loss_list_total"]) == 2


_SIGTERM_SCRIPT = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, {root!r})
    import torch
    torch.set_num_threads(1)
    from svs_torch.train import loop
    from svs_torch.utils.config import SVSConfig
    make = loop.make_train_step

    def stepping(cfg):
        step, calls = make(cfg), [0]

        def run(*args):
            calls[0] += 1
            if calls[0] == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*args)
        return run

    loop.make_train_step = stepping
    loop.fit(loop.TrainOptions(
        train_folder={songs!r}, valid_folder="none", load_path={init!r},
        label="t", epoch=3, batch_size=1, ckpt_dir={ckpt!r}, log_dir={log!r},
        progress=False, device="cpu"), SVSConfig(**{cfg!r}))
""")


def test_sigterm_saves_exits_143_and_resumes(data, tmp_path):
    songs, init = data
    ckpt, log = str(tmp_path / "CKPT"), str(tmp_path / "LOG")
    script = _SIGTERM_SCRIPT.format(root=ROOT, songs=songs, init=init,
                                    ckpt=ckpt, log=log, cfg=NARROW)
    proc = subprocess.run([sys.executable, "-c", script], timeout=300,
                          capture_output=True, text=True)
    assert proc.returncode == 143, proc.stderr[-2000:]
    with open(os.path.join(ckpt, "svs_t.ckpt"), "rb") as f:
        saved = fm.unpackb(f.read())
    # mid-epoch: epoch 0 is re-run on resume, after the two steps taken
    assert (saved["epoch"], saved["step"]) == (0, 2)
    state = tloop.fit(tloop.TrainOptions(
        train_folder=songs, valid_folder="none",
        load_path=os.path.join(ckpt, "svs_t.ckpt"), label="t", epoch=3,
        batch_size=1, ckpt_dir=ckpt, log_dir=log, progress=False,
        device="cpu"), TConfig(**NARROW))
    assert state.step == 2 + 3 * 4  # 4 patches an epoch, batch 1
    assert len(_lines(str(tmp_path), "log_t.txt")) == 3
    assert signal.getsignal(signal.SIGTERM) is not None


def test_fit_refuses_what_is_not_ported(data, tmp_path):
    songs, init = data
    one = Mesh(None, 0, 1, torch.device("cpu"))
    # ZeRO-1 and FSDP are ported (tests/test_torch_zero.py): they need a
    # mesh, and refuse epoch_scan with svs_tpu's message
    for kw in (dict(fsdp=True), dict(zero1=True)):
        with pytest.raises(ValueError, match="pass TrainOptions.mesh"):
            _port_fit(songs, init, str(tmp_path), **kw)
        with pytest.raises(ValueError, match="not cp/tp/zero1/fsdp"):
            _port_fit(songs, init, str(tmp_path), mesh=one, epoch_scan=True,
                      **kw)
    for kw, item in ((dict(device_put=lambda b: b), "A.10.7"),
                     (dict(parallel="cp"), "A.10.6"),
                     (dict(parallel="tp"), "A.10.4"),
                     (dict(parallel="pp"), "A.10.5"),
                     (dict(mesh=one, epoch_scan=True), "A.10.2")):
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP {item.replace('.', '[.]')}\\)"):
            _port_fit(songs, init, str(tmp_path), **kw)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        _port_fit(songs, init, str(tmp_path), mesh=object())


def test_train_cli_runs_an_epoch_on_the_cpu(data, tmp_path):
    """The default preset at its full width, float32, one step an epoch
    with augmentation, and a validation pass."""
    songs, _ = data
    rc = train_cli.main(["--label", "c", "--train_folder", songs,
                         "--valid_folder", songs, "--load_path",
                         str(tmp_path / "none.ckpt"),
                         "--epoch", "1", "--val_interval", "1",
                         "--batch_size", "2", "--samples_per_song", "1",
                         "--dtype", "float32", "--ckpt_dir",
                         str(tmp_path / "CKPT"), "--log_dir",
                         str(tmp_path / "LOG"), "--augment",
                         "--device", "cpu"])
    assert rc == 0
    lines = _lines(str(tmp_path), "log_c.txt")
    assert len(lines) == 2 and lines[1].startswith("Val ")
    assert all(np.isfinite(float(x.split()[-1])) for x in lines)
    assert sorted(os.listdir(tmp_path / "CKPT")) == ["svs_best_c.ckpt",
                                                     "svs_c.ckpt"]


@pytest.mark.parametrize("flag,item", [
    (["--multihost"], "A.10.7"), (["--coordinator", "h:1"], "A.10.7"),
    (["--dp", "--epoch_scan"], "A.10.2"), (["--cp"], "A.10.6"),
    (["--tp", "2"], "A.10.4"), (["--pp"], "A.10.5"),
    (["--zero1"], "A.10.3"), (["--fsdp"], "A.10.3"),
    (["--num_hosts", "2"], "A.10.7"), (["--host_id", "1"], "A.10.7")])
def test_train_cli_unported_flags_exit_2(flag, item, capsys):
    with pytest.raises(SystemExit) as err:
        train_cli.main(["--label", "x", "--device", "cpu", *flag])
    assert err.value.code == 2
    said = capsys.readouterr().err
    if item == "A.10.3":
        # ported (tests/test_torch_zero.py): without --dp they exit 2 as
        # svs_tpu's do
        assert "pass --dp with them" in said
    else:
        assert f"ROADMAP {item})" in said


def test_remat_gives_the_same_loss_and_gradients():
    """Recomputing the levels in the backward (with dropout on: the masks
    are drawn once, before each level) changes no value: the loss, every
    gradient and the BN running statistics are the same bits."""
    rng = np.random.default_rng(0)
    mix = torch.from_numpy(rng.random((2, 512, 128)).astype(np.float32))
    out = {}
    for remat in (False, True):
        cfg = TConfig(**{**NARROW, "dropout_rate": 0.5}, remat=remat)
        model = UNet(cfg, generator=torch.Generator().manual_seed(0)).train()
        gen = torch.Generator().manual_seed(3)
        loss = (model(mix, generator=gen) * mix).sum()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[remat] = (loss, grads, model.state_dict())
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_remat_train_step_matches_without(data):
    """One train step of the narrow model with remat equals the step
    without it (the step's loss, grad_norm and updated parameters)."""
    res = []
    for remat in (False, True):
        cfg = TConfig(**NARROW, remat=remat)
        state = tstep.create_train_state(0, cfg, device="cpu")
        ds = PatchDataset(data[0], samples_per_song=2, input_len=128)
        batch = {k: torch.from_numpy(v)
                 for k, v in next(iter(ds.batches(2, seed=0))).items()}
        state, m = tstep.make_train_step(cfg)(state, batch)
        res.append((m, state.model.state_dict()))
    for k in ("total", "grad_norm"):
        assert torch.equal(res[0][0][k], res[1][0][k]), k
    for k, v in res[0][1].items():
        assert torch.equal(res[1][1][k], v), k


def test_loop_options_are_svs_tpus():
    """TrainOptions has svs_tpu's fields and defaults, plus ``device``."""
    theirs = {f.name: f.default for f in
              dataclasses.fields(jloop.TrainOptions)}
    ours = {f.name: f.default for f in dataclasses.fields(
        tloop.TrainOptions)}
    assert ours.pop("device") is None
    assert ours == theirs

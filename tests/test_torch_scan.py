"""The port's whole-epoch training (``svs_torch.train.scan``, the
``epoch_scan`` branch of ``fit``) on the CPU, where ``epoch`` runs the
graph's per-step body eagerly.

- against ``svs_tpu.train.scan.make_epoch_scan`` on the same weights and
  index matrices: the narrow U-Net, float32, the exact ``fft`` loss,
  128-frame patches, dropout off (jax.random and torch.Generator draw
  different masks), three full steps.  Bounds: the per-step losses within
  1e-4 relative (one f32 step against another is within 1e-5,
  tests/test_torch_step.py, and three steps drift no further); the
  parameters within ``__graft_entry__.py``'s envelope for one step against
  another implementation, taken once a step: max |d| <= 3 * 2.1 lr, mean
  |d| < 3 * 2e-4;
- against the port's own per-step loop: on the CPU the two run the same
  operations on the same tensors, so a fit with ``epoch_scan`` writes the
  same log, the same checkpoints and the same final state, bit for bit,
  across the learning-rate drop and a ragged tail, with accumulation
  (``accum_steps = 2``, a cycle open across epochs) and with the remix
  augmentation; a resumed scan fit equals an uninterrupted one; SIGTERM
  under the scan saves at the epoch's end, exits 143 and resumes;
- what it refuses: a host dataset (``ValueError`` in svs_tpu's words) and
  a mesh that is not a ``parallel.mesh.Mesh`` (``TypeError``; the mesh
  variant is tests/test_torch_scan_mesh.py's).
"""

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
import jax.numpy as jnp

from svs_torch.data import device_data as tdd
from svs_torch.data.dataset import PatchDataset as TPatchDataset
from svs_torch.models import torch_import as t_import
from svs_torch.train import checkpoint as ckpt_lib
from svs_torch.train import loop as tloop
from svs_torch.train import scan as tscan
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.data import device_data as jdd
from svs_tpu.data.dataset import PatchDataset as JPatchDataset
from svs_tpu.train import scan as jscan
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 2 songs x 5 patches at B = 3: three full steps and a tail of one
NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), dropout_rate=0.0,
              mr_mag_impl="fft", samples_per_song=5, input_len=128,
              lr_drop_epoch=1, lr_after_drop=5e-4)
B = 3


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


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scan"))
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


def test_epoch_matches_svs_tpus_epoch_scan(songs):
    jcfg, tcfg = JConfig(**NARROW), TConfig(**NARROW)
    jopt = jstep.make_optimizer(jcfg)
    jstate = jstep.create_train_state(jax.random.key(0), jcfg, jopt)
    tstate = tstep.create_train_state(0, tcfg, device="cpu")
    tstate.model.load_state_dict(t_import.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state)))

    host = TPatchDataset(songs, samples_per_song=5, input_len=128)
    s, st, tail = tdd.epoch_index_arrays(host, B, shuffle=True, seed=7)
    assert s.shape == (3, B) and tail is not None
    jds = jdd.DeviceDataset(JPatchDataset(songs, samples_per_song=5,
                                          input_len=128))
    jstate, _, jlosses = jscan.make_epoch_scan(jcfg, jopt)(
        jstate, jds.planes, jnp.asarray(s), jnp.asarray(st),
        jax.random.key(1))
    tds = tdd.DeviceDataset(host, device="cpu")
    tstate, tlosses = tscan.make_epoch_scan(tcfg)(
        tstate, tds.planes, s, st, torch.Generator().manual_seed(1))

    assert tstate.step == int(jstate.step) == 3
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    want = t_import.state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state))
    got = tstate.model.state_dict()
    d = [np.abs(got[k].numpy() - w.numpy()).ravel() for k, w in want.items()
         if "running" not in k and "num_batches" not in k]
    d = np.concatenate(d)
    lr = tcfg.learning_rate
    assert d.max() <= 3 * 2.1 * lr and d.mean() < 3 * 2e-4, (d.max(),
                                                             d.mean())


def _opts(songs, out, **kw):
    base = dict(train_folder=songs, valid_folder="none", load_path="none",
                label="t", epoch=2, batch_size=B, device_data="on",
                ckpt_dir=os.path.join(out, "CKPT"),
                log_dir=os.path.join(out, "LOG"), progress=False,
                device="cpu")
    base.update(kw)
    return tloop.TrainOptions(**base)


def _fit(songs, out, cfg=None, **kw):
    return tloop.fit(_opts(songs, out, **kw), TConfig(**(cfg or NARROW)))


def _files(out):
    found = {}
    for sub in ("CKPT", "LOG"):
        for name in sorted(os.listdir(os.path.join(out, sub))):
            with open(os.path.join(out, sub, name), "rb") as f:
                found[name] = f.read()
    return found


def _same_state(a, b):
    assert a.step == b.step and a.mini_step == b.mini_step
    theirs = b.model.state_dict()
    for k, v in a.model.state_dict().items():
        if "num_batches" not in k:  # not in svs_tpu's format, never read
            assert torch.equal(theirs[k], v), k


@pytest.mark.parametrize("kw", [
    dict(),
    dict(accum_steps=2),
    dict(augment=True),
], ids=["plain", "accum2", "augment"])
def test_fit_with_epoch_scan_is_the_per_step_fit(songs, tmp_path, kw):
    """Two epochs across the learning-rate drop (at epoch 1), three full
    steps and a tail an epoch, dropout on: the same bits as the loop."""
    cfg = dict(NARROW, dropout_rate=0.5)
    per_step = _fit(songs, str(tmp_path / "step"), cfg, **kw)
    scanned = _fit(songs, str(tmp_path / "scan"), cfg, epoch_scan=True, **kw)
    _same_state(per_step, scanned)
    want = _files(str(tmp_path / "step"))
    got = _files(str(tmp_path / "scan"))
    assert sorted(got) == sorted(want) == [
        "log_t.txt", "metrics_t.jsonl", "svs_t.ckpt", "svs_t_400.ckpt"]
    for name in ("log_t.txt", "svs_t.ckpt", "svs_t_400.ckpt"):
        assert got[name] == want[name], name
    lrs = [line for line in got["metrics_t.jsonl"].decode().splitlines()]
    assert '"lr": 0.0005' in lrs[1] and '"steps": 4' in lrs[1]
    if kw.get("accum_steps") == 2:
        # 8 microbatches: the cycle closed at the tail, acc_grads dropped
        assert scanned.mini_step == 0 and scanned.acc_grads is None


def test_an_accumulation_cycle_open_across_the_epoch_end(songs, tmp_path):
    """``accum_steps = 3``: each epoch's 4 microbatches leave a cycle open,
    which the state's accumulation buffers carry into the checkpoint and
    the next epoch's replays."""
    kw = dict(accum_steps=3, epoch=1)
    one = _fit(songs, str(tmp_path / "step"), **kw)
    two = _fit(songs, str(tmp_path / "scan"), epoch_scan=True, **kw)
    _same_state(one, two)
    assert two.mini_step == 1 and two.acc_grads is not None
    for a, b in zip(one.acc_grads, two.acc_grads):
        assert torch.equal(a, b)
    assert (_files(str(tmp_path / "step"))["svs_t.ckpt"]
            == _files(str(tmp_path / "scan"))["svs_t.ckpt"])


def test_accumulation_keeps_one_storage():
    """MultiSteps' running mean lives in buffers allocated at the first
    microbatch and reused by every later cycle (a CUDA graph of the step
    holds their addresses); ``acc_grads`` is them while a cycle is open,
    None once it closes."""
    cfg = TConfig(**NARROW)
    state = tstep.create_train_state(0, cfg, tstep.make_optimizer(cfg, 2),
                                     device="cpu")
    step = tstep.make_step_fn(cfg)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    ptrs = None
    for i in range(4):
        batch = {k: torch.from_numpy(rng.random((B, 512, 128),
                                                dtype=np.float32))
                 for k in ("mix", "voc", "mix_angle", "voc_angle")}
        state, _ = step(state, batch, gen)
        if i % 2 == 0:
            assert state.acc_grads is state.acc_buffers
        else:
            assert state.acc_grads is None and state.mini_step == 0
        now = [t.data_ptr() for t in state.acc_buffers]
        assert ptrs is None or now == ptrs
        ptrs = now
    assert not state.optimizer.param_groups[0]["capturable"]


def test_resumed_scan_fit_equals_an_uninterrupted_one(songs, tmp_path):
    """Both start from one ``.ckpt`` (a resumed Adam takes the file's
    float32 betas, so a fresh start would differ from either)."""
    init = str(tmp_path / "init.ckpt")
    ckpt_lib.save(init, tstep.create_train_state(0, TConfig(**NARROW),
                                                 device="cpu"))
    full = _fit(songs, str(tmp_path / "full"), epoch_scan=True,
                load_path=init)
    half = str(tmp_path / "half")
    _fit(songs, half, epoch=1, epoch_scan=True, load_path=init)
    resumed = _fit(songs, half, epoch=2, epoch_scan=True,
                   load_path=os.path.join(half, "CKPT", "svs_t.ckpt"))
    _same_state(full, resumed)
    assert (_files(half)["log_t.txt"]
            == _files(str(tmp_path / "full"))["log_t.txt"])


_SIGTERM_SCRIPT = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, {root!r})
    import torch
    torch.set_num_threads(1)
    from svs_torch.train import loop, scan
    from svs_torch.utils.config import SVSConfig
    make = scan.make_epoch_scan

    def stopping(*a, **k):
        epoch = make(*a, **k)

        def run(*args):
            os.kill(os.getpid(), signal.SIGTERM)
            return epoch(*args)
        return run

    scan.make_epoch_scan = stopping
    loop.fit(loop.TrainOptions(
        train_folder={songs!r}, valid_folder="none", load_path={init!r},
        label="t", epoch=3, batch_size={b}, ckpt_dir={ckpt!r},
        log_dir={log!r}, progress=False, device="cpu", device_data="on",
        epoch_scan=True), SVSConfig(**{cfg!r}))
""")


def test_sigterm_under_epoch_scan_saves_exits_143_and_resumes(songs,
                                                               tmp_path):
    ckpt, log = str(tmp_path / "CKPT"), str(tmp_path / "LOG")
    script = _SIGTERM_SCRIPT.format(root=ROOT, songs=songs, init="none",
                                    ckpt=ckpt, log=log, cfg=NARROW, b=B)
    proc = subprocess.run([sys.executable, "-c", script], timeout=300,
                          capture_output=True, text=True)
    assert proc.returncode == 143, proc.stderr[-2000:]
    from svs_torch.train import flax_msgpack as fm
    with open(os.path.join(ckpt, "svs_t.ckpt"), "rb") as f:
        saved = fm.unpackb(f.read())
    # the stop is served at the epoch's end: epoch 1 done, 4 steps
    assert (saved["epoch"], saved["step"]) == (1, 4)
    state = _fit(songs, str(tmp_path), epoch=3, epoch_scan=True,
                 load_path=os.path.join(ckpt, "svs_t.ckpt"))
    assert state.step == 3 * 4
    assert signal.getsignal(signal.SIGTERM) is not None


def test_epoch_scan_refuses_a_host_dataset_and_a_mesh(songs, tmp_path):
    with pytest.raises(ValueError, match="device-resident dataset"):
        _fit(songs, str(tmp_path), epoch_scan=True, device_data="off")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tscan.make_epoch_scan(TConfig(**NARROW), mesh=object())

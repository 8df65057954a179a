"""The port's device-resident dataset against the host sampler and against
svs_tpu's DeviceDataset, on the CPU: batches bitwise equal for one seed,
with and without ``drop_last`` and ``n_steps``."""

import os

import numpy as np
import pytest
import torch

from svs_torch.data import device_data as tdd
from svs_torch.data.dataset import PatchDataset as TPatchDataset
from svs_torch.parallel.mesh import Mesh
from svs_tpu.data import device_data as jdd
from svs_tpu.data.dataset import PatchDataset as JPatchDataset

KEYS = ("mix", "voc", "mix_angle", "voc_angle")


def _make_spec_dataset(root, frames, seed=0):
    rng = np.random.default_rng(seed)
    for folder in ("mixture", "vocal"):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
    for i, t in enumerate(frames):
        base = f"{i:04d}_s{i}"
        for folder in ("mixture", "vocal"):
            np.save(os.path.join(root, folder, f"{base}_spec.npy"),
                    rng.random((513, t)).astype(np.float32))
            ang = rng.random((513, t)).astype(np.float32) * 6 - 3
            np.save(os.path.join(root, folder, f"{base}_phase.npy"),
                    np.exp(1j * ang).astype(np.complex64))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # one song LONGER than input_len, one exactly at it, one SHORTER (the
    # zero-pad branch, reference train.py:127-135)
    path = str(tmp_path_factory.mktemp("device_data"))
    _make_spec_dataset(path, frames=(300, 128, 70))
    return path


def _datasets(root):
    kw = dict(samples_per_song=4, input_len=128)
    return TPatchDataset(root, **kw), JPatchDataset(root, **kw)


@pytest.mark.parametrize("kw", [
    dict(batch_size=5, seed=0),
    dict(batch_size=5, seed=3),
    dict(batch_size=4, seed=1, n_steps=7),       # wraparound
    dict(batch_size=5, seed=2, drop_last=True),
    dict(batch_size=3, seed=4, shuffle=False),
])
def test_device_batches_equal_host_and_jax(root, kw):
    host, jhost = _datasets(root)
    dev = tdd.DeviceDataset(host, device="cpu")
    jdev = jdd.DeviceDataset(jhost)
    hb, db, jb = (list(d.batches(**kw)) for d in (host, dev, jdev))
    assert len(hb) == len(db) == len(jb) > 0
    for h, d, j in zip(hb, db, jb):
        for k in KEYS:
            assert d[k].dtype == torch.float32
            np.testing.assert_array_equal(d[k].numpy(), h[k], err_msg=k)
            np.testing.assert_array_equal(d[k].numpy(), np.asarray(j[k]),
                                          err_msg=k)


def test_gather_at_explicit_indices(root):
    host, _ = _datasets(root)
    dev = tdd.DeviceDataset(host, device="cpu")
    got = dev.gather(np.array([0, 2, 1]), np.array([172, 0, 0]))
    for j, (song, start) in enumerate(((0, 172), (2, 0), (1, 0))):
        want = host.crop(song, start)
        for k, w in zip(KEYS, want):
            np.testing.assert_array_equal(got[k][j].numpy(), w, err_msg=k)


def test_resident_bytes_and_index_arrays_equal_jax(root):
    host, jhost = _datasets(root)
    dev = tdd.DeviceDataset(host, device="cpu")
    assert tdd.resident_bytes(host) == jdd.resident_bytes(jhost) == dev.nbytes
    assert dev.nbytes == 4 * 3 * 512 * 300 * 4
    assert len(dev) == 12 and dev.n_songs == 3 and dev.input_len == 128
    assert dev.steps_per_epoch(5) == 3 and dev.steps_per_epoch(5, True) == 2
    for kw in (dict(seed=5), dict(seed=6, drop_last=True),
               dict(seed=7, n_steps=4)):
        got = tdd.epoch_index_arrays(host, 5, **kw)
        want = jdd.epoch_index_arrays(jhost, 5, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert (got[2] is None) == (want[2] is None)
        if got[2] is not None:
            np.testing.assert_array_equal(got[2][0], want[2][0])
            np.testing.assert_array_equal(got[2][1], want[2][1])


def test_gate_and_the_mesh_modes(root):
    host, _ = _datasets(root)
    cpu = dict(device="cpu")
    assert isinstance(tdd.maybe_device_dataset(host, "on", 0.0001, **cpu),
                      tdd.DeviceDataset)
    assert tdd.maybe_device_dataset(host, "off", 1e9, **cpu) is host
    assert tdd.maybe_device_dataset(host, "auto", 0.0001, **cpu) is host
    assert isinstance(tdd.maybe_device_dataset(host, "auto", 1e9, **cpu),
                      tdd.DeviceDataset)
    assert tdd.maybe_device_dataset(None, "on", 1e9, **cpu) is None
    with pytest.raises(ValueError):
        tdd.maybe_device_dataset(host, "yes", 1e9, **cpu)
    # a mesh: the planes on the mesh's device, and every rank's batches the
    # global batch's (tests/test_torch_dp.py cuts them with shard_batch)
    want = next(iter(tdd.DeviceDataset(host, device="cpu").batches(
        3, seed=0)))
    for rank in (0, 1):
        mesh = Mesh(None, rank, 2, torch.device("cpu"))
        ds = tdd.maybe_device_dataset(host, "on", 1e9, mesh=mesh)
        assert isinstance(ds, tdd.DeviceDataset)
        assert ds.device == mesh.device
        batch = next(iter(ds.batches(3, seed=0)))
        assert sorted(batch) == sorted(want)
        for k in want:
            assert torch.equal(batch[k], want[k]), k


def test_raises_without_gpu(root, monkeypatch):
    host, _ = _datasets(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdd.DeviceDataset(host)

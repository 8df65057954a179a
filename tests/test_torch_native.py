"""The port's loader of the C++ data runtime (``svs_torch.data.native``)
and the native backend of its ``PatchDataset``, against svs_tpu's.

Both build ``native/svs_native.cpp``; the port into ``svs_torch/_build/``,
never under ``native/``.  Batches are compared bit for bit (magnitudes are
copied either way, and every backend takes its angles from one per-song
numpy cache), WAV decodes against svs_tpu's native reader bit for bit and
against the numpy parser within 1e-6 (the 16-bit PCM scale, svs_tpu's
test_native.py bound).
"""

import os
import shutil

import numpy as np
import pytest

from svs_torch.data import dataset as tds
from svs_torch.data import native
from svs_torch.data import wav as twav
from svs_tpu.data import dataset as jds
from svs_tpu.data import native as jnative
from svs_tpu.data import wav as jwav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no g++ to build the native library")


@pytest.fixture(scope="module")
def spec_dir(tmp_path_factory):
    """Three songs, one shorter than a 128-frame patch."""
    root = str(tmp_path_factory.mktemp("native"))
    rng = np.random.default_rng(0)
    for folder in ("mixture", "vocal"):
        os.makedirs(os.path.join(root, folder))
    for i, t in enumerate((200, 50, 170)):
        for folder in ("mixture", "vocal"):
            np.save(os.path.join(root, folder, f"{i:04d}_s{i}_spec.npy"),
                    rng.random((513, t)).astype(np.float32))
            ang = rng.uniform(-3, 3, (513, t)).astype(np.float32)
            np.save(os.path.join(root, folder, f"{i:04d}_s{i}_phase.npy"),
                    np.exp(1j * ang).astype(np.complex64))
    return root


def test_native_batches_are_numpys_and_svs_tpus(spec_dir):
    ours = tds.PatchDataset(spec_dir, samples_per_song=4, backend="native")
    assert ours.backend == "native"
    others = [tds.PatchDataset(spec_dir, samples_per_song=4,
                               backend="numpy"),
              jds.PatchDataset(spec_dir, samples_per_song=4,
                               backend="numpy")]
    if jnative.available():
        others.append(jds.PatchDataset(spec_dir, samples_per_song=4,
                                       backend="native"))
    want = [list(ds.batches(5, seed=7)) for ds in others]
    got = list(ours.batches(5, seed=7))
    assert [b["mix"].shape[0] for b in got] == [5, 5, 2]
    for w in want:
        assert len(w) == len(got)
        for a, b in zip(got, w):
            for k in tds.PLANE_KEYS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the short song's crop is zero-padded in every plane
    short = ours._native_batch([1], np.zeros(1, np.int64))
    for k in tds.PLANE_KEYS:
        assert short[k].shape == (1, 512, 128)
        assert (short[k][0, :, 50:] == 0).all()


def test_npy_handles(tmp_path):
    p = str(tmp_path / "a.npy")
    np.save(p, np.arange(12, dtype=np.float32).reshape(3, 4))
    h = native.NpyHandle(p)
    assert (h.rows, h.cols, h.dtype) == (3, 4, "f4")
    h.close()
    with pytest.raises(OSError):
        native.NpyHandle(str(tmp_path / "missing.npy"))
    np.save(p, np.zeros((3, 4), np.float64))
    with pytest.raises(OSError):
        native.NpyHandle(p)


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_read_wav_is_svs_tpus(tmp_path, subtype):
    rng = np.random.default_rng(1)
    y = (rng.standard_normal((2, 5000)) * 0.3).astype(np.float32)
    p = str(tmp_path / "s.wav")
    twav.write_wav(p, y, 8192, subtype=subtype)
    mono, sr = native.read_wav(p, mono=True)
    stereo, _ = native.read_wav(p, mono=False)
    assert sr == 8192 and mono.shape == (5000,) and stereo.shape == (2, 5000)
    parsed, _ = twav.read_wav(p)
    np.testing.assert_allclose(stereo, parsed, atol=1e-6)
    np.testing.assert_allclose(mono, twav.to_mono(parsed), atol=1e-6)
    if jnative.available():
        for m, got in ((True, mono), (False, stereo)):
            want, _ = jnative.read_wav(p, mono=m)
            np.testing.assert_array_equal(got, want)
    # load_audio takes the native decode, as svs_tpu's
    ours, sr1 = twav.load_audio(p, sr=None, mono=True)
    theirs, sr2 = jwav.load_audio(p, sr=None, mono=True)
    assert sr1 == sr2 == 8192
    np.testing.assert_array_equal(ours, mono)
    if jnative.available():
        np.testing.assert_array_equal(ours, theirs)


def _tree(folder):
    return {f: os.path.getmtime(os.path.join(folder, f))
            for f in sorted(os.listdir(folder))}


def test_the_library_is_built_under_svs_torch_build(tmp_path, monkeypatch):
    """The port's library lives in svs_torch/_build/; a build from a copy
    of the source writes only into the build folder, and a newer source
    builds again."""
    build_dir = os.path.join(ROOT, "svs_torch", "_build")
    assert os.path.dirname(native.SO_PATH) == build_dir
    assert os.path.exists(native.SO_PATH)
    assert native.SRC_PATH == os.path.join(ROOT, "native", "svs_native.cpp")
    cpp_mtime = os.path.getmtime(native.SRC_PATH)

    src_dir, out_dir = tmp_path / "native", tmp_path / "build"
    os.makedirs(src_dir)
    src = str(src_dir / "svs_native.cpp")
    shutil.copy2(native.SRC_PATH, src)
    before = _tree(src_dir)
    so = str(out_dir / "libsvs_native.so")
    monkeypatch.setattr(native, "SRC_PATH", src)
    monkeypatch.setattr(native, "BUILD_DIR", str(out_dir))
    monkeypatch.setattr(native, "SO_PATH", so)
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    assert _tree(src_dir) == before
    assert sorted(os.listdir(out_dir)) == ["libsvs_native.so"]
    built = os.path.getmtime(so)
    os.utime(src, (built + 10, built + 10))
    monkeypatch.setattr(native, "_lib", None)
    assert native.available() and os.path.getmtime(so) > built
    assert os.path.getmtime(native.__dict__["SRC_PATH"]) == built + 10
    # the repository's source was only read
    assert os.path.getmtime(os.path.join(ROOT, "native",
                                         "svs_native.cpp")) == cpp_mtime


def test_an_explicit_native_backend_that_cannot_load_raises(
        spec_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "SRC_PATH", str(tmp_path / "none.cpp"))
    monkeypatch.setattr(native, "SO_PATH", str(tmp_path / "none.so"))
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="could not be built or loaded"):
        tds.PatchDataset(spec_dir, backend="native")
    assert tds.PatchDataset(spec_dir, backend="auto").backend == "numpy"

"""The port's patch sampler (``svs_torch.data.dataset``, numpy backend)
against svs_tpu's on the files the port's ``to_spec`` writes.

Both are the same host numpy code and one seeded RNG stream, so batches
must be bitwise equal; one song is shorter than ``input_len`` (the
zero-padded branch).
"""

import os

import numpy as np
import pytest

from svs_torch.data import dataset as tds
from svs_torch.data import prep as tprep
from svs_torch.data import wav as twav
from svs_tpu.data import dataset as jds

SR = 8192


@pytest.fixture(scope="module")
def spec_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataset")
    rng = np.random.default_rng(0)
    # 9.5 s gives 102 frames, fewer than input_len = 128
    for i, seconds in enumerate((21.0, 9.5, 30.2)):
        d = root / "songs" / f"song{i}"
        os.makedirs(d)
        n = int(seconds * SR)
        voc = (0.3 * np.sin(np.arange(n) * 0.07)).astype(np.float32)
        mix = (voc + 0.2 * rng.standard_normal(n)).astype(np.float32)
        twav.write_wav(str(d / "mixture.wav"), mix, SR)
        twav.write_wav(str(d / "vocals.wav"), voc, SR)
    out = str(root / "spec")
    assert tprep.to_spec(str(root / "songs"), out, win_size=1024,
                         hop_size=768, sr=SR, progress=False,
                         device="cpu") == 3
    return out


@pytest.mark.parametrize("kw", [dict(), dict(n_steps=5),
                                dict(drop_last=True, shuffle=False)])
def test_batches_bitwise_equal(spec_dir, kw):
    t = tds.PatchDataset(spec_dir, samples_per_song=6, backend="numpy")
    j = jds.PatchDataset(spec_dir, samples_per_song=6, backend="numpy")
    assert t.file_names == j.file_names and len(t) == len(j) == 18
    assert min(t.song_length(i) for i in range(3)) < t.input_len
    got = list(t.batches(4, seed=7, **kw))
    want = list(j.batches(4, seed=7, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert list(a) == list(tds.PLANE_KEYS) == list(b)
        for k in tds.PLANE_KEYS:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    assert t.steps_per_epoch(4, **{k: v for k, v in kw.items()
                                   if k == "drop_last"}) == \
        j.steps_per_epoch(4, **{k: v for k, v in kw.items()
                                if k == "drop_last"})


def test_index_stream_and_sample_match(spec_dir):
    t = tds.PatchDataset(spec_dir, samples_per_song=4)
    j = jds.PatchDataset(spec_dir, samples_per_song=4, backend="numpy")
    for (ti, ts), (ji, js) in zip(t.index_batches(3, seed=1),
                                  j.index_batches(3, seed=1)):
        assert ti == ji
        np.testing.assert_array_equal(ts, js)
    for a, b in zip(t.sample(1, np.random.default_rng(3)),
                    j.sample(1, np.random.default_rng(3))):
        np.testing.assert_array_equal(a, b)


def test_native_backend_is_not_ported(spec_dir):
    assert tds.PatchDataset(spec_dir, backend="auto").backend == "numpy"
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tds.PatchDataset(spec_dir, backend="native")
    with pytest.raises(FileNotFoundError):
        tds.PatchDataset(os.path.join(spec_dir, "missing"))


def test_producer_errors_reach_the_consumer(spec_dir, monkeypatch):
    ds = tds.PatchDataset(spec_dir, samples_per_song=2)

    def boom(*_):
        raise OSError("disk gone")

    monkeypatch.setattr(ds, "crop", boom)
    with pytest.raises(OSError, match="disk gone"):
        list(ds.batches(2, seed=0))

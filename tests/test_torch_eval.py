"""The port's evaluation against svs_tpu's on the CPU:
``svs_torch.evaluation.val_sdr.validation_sdr`` and ``fit(val_sdr=True)``,
and the ``eval_cli`` (``--impl numpy`` and ``--impl torch``).

Songs are synthetic (a sine vocal over noise) at 8192 Hz, made into
spectra by the port's ``to_spec``; the weights are svs_tpu's seeded narrow
U-Net in float32, crossed with ``torch_import.state_dict_from_jax``.
Bounds:
- ``eval_cli`` on the same wavs: 1e-9 dB, both sides float64 BSS eval of
  the same samples (tests/test_bss_jax.py's bound);
- ``validation_sdr``: the two packages decode each song with their own
  float32 convs and iSTFT, whose masks agree to ~1e-6 relative
  (tests/test_torch_unet.py), and an SDR moves by 10/ln 10 times the
  relative change of its energy ratio, so 1e-4 dB; the port's two BSS
  backends on its own decode: 1e-9 dB.
"""

import csv
import json
import os

import numpy as np
import pytest

import jax

from svs_torch.cli import eval_cli as t_eval_cli
from svs_torch.cli import train_cli
from svs_torch.data import prep as tprep
from svs_torch.data import wav as twav
from svs_torch.evaluation import val_sdr as tval
from svs_torch.models import torch_import as t_import
from svs_torch.models.unet import UNet
from svs_torch.train import loop as tloop
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.cli import eval_cli as j_eval_cli
from svs_tpu.evaluation import val_sdr as jval
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

SR = 8192
NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), dropout_rate=0.0,
              input_len=128, samples_per_song=2, compute_dtype="float32")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three songs as wavs (mixture, vocals) and as spectra, plus a folder
    of separated-vocal stand-ins (the vocal with some accompaniment)."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    wavs = {k: root / k for k in ("mix", "ref", "est")}
    for d in wavs.values():
        os.makedirs(d)
    for i, seconds in enumerate((4.0, 3.0, 5.5)):
        d = root / "songs" / f"song{i}"
        os.makedirs(d)
        n = int(seconds * SR)
        t = np.arange(n) / SR
        voc = (0.3 * np.sin(2 * np.pi * (220 + 40 * i) * t)
               * (1 + 0.5 * np.sin(2 * np.pi * 0.5 * t))).astype(np.float32)
        acc = (0.2 * rng.standard_normal(n)).astype(np.float32)
        mix = voc + acc
        twav.write_wav(str(d / "mixture.wav"), mix, SR)
        twav.write_wav(str(d / "vocals.wav"), voc, SR)
        twav.write_wav(str(wavs["mix"] / f"song{i}.wav"), mix, SR)
        twav.write_wav(str(wavs["ref"] / f"song{i}.wav"), voc, SR)
        twav.write_wav(str(wavs["est"] / f"song{i}.wav"),
                       voc + (0.3 + 0.2 * i) * acc, SR)
    spec = str(root / "spec")
    assert tprep.to_spec(str(root / "songs"), spec, win_size=1024,
                         hop_size=768, sr=SR, progress=False,
                         device="cpu") == 3
    return {k: str(v) for k, v in wavs.items()}, spec


@pytest.fixture(scope="module")
def weights():
    cfg = JConfig(**NARROW)
    state = jstep.create_train_state(jax.random.key(0), cfg)
    params = jax.tree.map(np.asarray, state.params)
    bn = jax.tree.map(np.asarray, state.bn_state)
    model = UNet(TConfig(**NARROW))
    model.load_state_dict(t_import.state_dict_from_jax(params, bn))
    return params, bn, model.eval()


def test_validation_sdr_matches_svs_tpus(data, weights):
    _, spec = data
    params, bn, model = weights
    want = jval.validation_sdr(params, bn, spec, JConfig(**NARROW),
                               impl="numpy")
    got = tval.validation_sdr(model, spec, TConfig(**NARROW), impl="numpy",
                              device="cpu")
    on_device = tval.validation_sdr(model, spec, TConfig(**NARROW),
                                    impl="torch", device="cpu")
    assert want["skipped"] == got["skipped"] == on_device["skipped"] == []
    assert ([s["song"] for s in got["per_song"]]
            == [s["song"] for s in want["per_song"]]
            == ["0000_song0", "0001_song1", "0002_song2"])
    for k in ("SDR", "SIR", "SAR", "NSDR"):
        assert abs(got[k] - want[k]) < 1e-4, k
        assert abs(on_device[k] - got[k]) < 1e-9, k
        for a, b in zip(got["per_song"], want["per_song"]):
            assert abs(a[k] - b[k]) < 1e-4, (a["song"], k)
    assert not model.training


def test_validation_sdr_skips_what_it_cannot_score(data, weights, tmp_path):
    """An all-silent vocal (BSS eval is undefined there) and a song without
    its phase file are skipped, the rest scored; the model's train mode
    comes back."""
    _, spec = data
    _, _, model = weights
    for folder in ("mixture", "vocal"):
        os.makedirs(tmp_path / folder)
        for name in sorted(os.listdir(os.path.join(spec, folder))):
            arr = np.load(os.path.join(spec, folder, name))
            if folder == "vocal" and name.startswith("0001"):
                arr = np.zeros_like(arr)
            if not (name.startswith("0002") and name.endswith("_phase.npy")
                    and folder == "vocal"):
                np.save(str(tmp_path / folder / name), arr)
    model.train()
    out = tval.validation_sdr(model, str(tmp_path), TConfig(**NARROW),
                              device="cpu")
    assert model.training
    model.eval()
    assert [s["song"] for s in out["per_song"]] == ["0000_song0"]
    assert len(out["skipped"]) == 2
    assert "all-silent" in out["skipped"][0]
    one = tval.validation_sdr(model, str(tmp_path), TConfig(**NARROW),
                              device="cpu", max_songs=1)
    assert one["SDR"] == out["SDR"] and len(one["per_song"]) == 1


def _csv(path):
    with open(path) as f:
        return {r["track"]: {k: float(r[k]) for k in
                             ("SDR", "SIR", "SAR", "NSDR")}
                for r in csv.DictReader(f)}


def test_eval_cli_matches_svs_tpus(data, tmp_path):
    wavs, _ = data
    argv = ["--est", wavs["est"], "--mix", wavs["mix"], "--ref", wavs["ref"]]
    assert j_eval_cli.main(argv + ["--out_csv",
                                   str(tmp_path / "j.csv")]) == 0
    want = _csv(tmp_path / "j.csv")
    assert sorted(want) == ["song0", "song1", "song2"]
    for impl in ("numpy", "torch"):
        out = str(tmp_path / f"{impl}.csv")
        assert t_eval_cli.main(argv + ["--impl", impl, "--device", "cpu",
                                       "--out_csv", out]) == 0
        got = _csv(out)
        assert sorted(got) == sorted(want)
        for track, m in want.items():
            for k, v in m.items():
                assert abs(got[track][k] - v) < 1e-9, (impl, track, k)


def test_eval_cli_pool_and_device(data):
    wavs, _ = data
    assert t_eval_cli._pool_context("torch").get_start_method() == "spawn"
    assert t_eval_cli._pool_context("numpy").get_start_method() in (
        "fork", "spawn")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_eval_cli.main(["--est", wavs["est"], "--mix", wavs["mix"],
                             "--ref", wavs["ref"], "--impl", "torch"])


def test_fit_with_val_sdr_writes_the_sdr_fields(data, tmp_path):
    _, spec = data
    opts = tloop.TrainOptions(
        train_folder=spec, valid_folder=spec, load_path="none", label="v",
        epoch=1, batch_size=2, val_interval=1, val_sdr=True,
        val_sdr_songs=1, ckpt_dir=str(tmp_path / "CKPT"),
        log_dir=str(tmp_path / "LOG"), progress=False, device="cpu")
    state = tloop.fit(opts, TConfig(**NARROW))
    with open(tmp_path / "LOG" / "metrics_v.jsonl") as f:
        records = [json.loads(x) for x in f]
    val = records[-1]
    assert sorted(val) == ["epoch", "sdr_songs", "val_loss", "vocal_nsdr",
                           "vocal_sar", "vocal_sdr", "vocal_sir"]
    assert val["sdr_songs"] == 1
    assert all(np.isfinite(val[k]) for k in val)
    assert state.model.training


def test_train_cli_epoch_scan_and_val_sdr(data, tmp_path):
    """The slice's command on the host: the default preset at full width
    (float32), the epoch as the scan's eager body, then BSS eval."""
    _, spec = data
    rc = train_cli.main(["--label", "c", "--train_folder", spec,
                         "--valid_folder", spec, "--load_path",
                         str(tmp_path / "none.ckpt"), "--epoch", "1",
                         "--val_interval", "1", "--batch_size", "2",
                         "--samples_per_song", "1", "--dtype", "float32",
                         "--epoch_scan", "--val_sdr", "--val_sdr_songs", "1",
                         "--ckpt_dir", str(tmp_path / "CKPT"), "--log_dir",
                         str(tmp_path / "LOG"), "--device", "cpu"])
    assert rc == 0
    with open(tmp_path / "LOG" / "metrics_c.jsonl") as f:
        records = [json.loads(x) for x in f]
    assert records[0]["steps"] == 2  # 3 patches at B = 2: one full, a tail
    assert records[1]["sdr_songs"] == 1
    assert np.isfinite(records[1]["vocal_sdr"])

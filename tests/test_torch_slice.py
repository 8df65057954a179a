"""The port's separation pipeline (wav -> to_spec -> U-Net -> to_wave)
against svs_tpu's, end to end on the CPU.

Two synthetic songs of ~20 s (numpy seed) go through both packages with the
same weights (svs_tpu ``unet.init`` -> ``state_dict_from_jax``) on a narrow
float32 config.  Tolerances:
- spectra: 1e-5 on the normalised magnitude (<= 1) and on mag * phase (f32
  FFTs in different summation orders; the unit phase itself is compared
  through the complex spectrum because it is ill-conditioned at small |S|);
- masked spectra: 1e-5 (f32 U-Net, ~1e-6 observed);
- waveforms: 2 LSB of PCM16 (round-to-nearest of values that agree to f32
  precision can still land one code apart; both sides peak-normalise).
"""

import os

import numpy as np
import pytest
import torch

import jax

from svs_torch.cli import data_cli as t_data_cli
from svs_torch.cli import infer_cli as t_infer_cli
from svs_torch.data import prep as tprep
from svs_torch.data import wav as twav
from svs_torch.infer import separate as tsep
from svs_torch.models import torch_import as t_import
from svs_torch.models.unet import UNet
from svs_torch.utils.config import SVSConfig as TConfig
from svs_torch.utils.config import get_config
from svs_tpu.data import prep as jprep
from svs_tpu.infer import separate as jsep
from svs_tpu.models import unet as junet
from svs_tpu.utils.config import SVSConfig as JConfig

SR = 8192
NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16))
GEOM = dict(win_size=1024, hop_size=768, sr=SR)


def _song(rng, seconds):
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(150, 600)
    vocal = 0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.01 * np.sin(t)))
    accomp = 0.2 * rng.standard_normal(len(t))
    return ((vocal + accomp).astype(np.float32),
            vocal.astype(np.float32))


def _make_songs(root, seconds=(20.0, 17.3), seed=0):
    rng = np.random.default_rng(seed)
    for i, s in enumerate(seconds):
        d = os.path.join(root, f"song{i}")
        os.makedirs(d)
        mix, voc = _song(rng, s)
        twav.write_wav(os.path.join(d, "mixture.wav"), mix, SR)
        twav.write_wav(os.path.join(d, "vocals.wav"), voc, SR)
    return root


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig(**NARROW)
    params, state = jax.jit(junet.init, static_argnums=1)(
        jax.random.key(0), jcfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    model = UNet(TConfig(**NARROW))
    model.load_state_dict(t_import.state_dict_from_jax(params, state))
    return jcfg, params, state, model.eval()


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    src = _make_songs(str(root / "songs"))
    jtar, ttar = str(root / "jax_spec"), str(root / "torch_spec")
    assert jprep.to_spec(src, jtar, progress=False, **GEOM) == 2
    assert tprep.to_spec(src, ttar, progress=False, device="cpu", **GEOM) == 2
    return root, jtar, ttar


def test_to_spec_files_match(specs):
    _, jtar, ttar = specs
    for folder in ("mixture", "vocal"):
        names = sorted(os.listdir(os.path.join(jtar, folder)))
        assert names == sorted(os.listdir(os.path.join(ttar, folder)))
        assert len(names) == 4
        for name in names:
            if not name.endswith("_spec.npy"):
                continue
            jm = np.load(os.path.join(jtar, folder, name))
            tm = np.load(os.path.join(ttar, folder, name))
            ph = name.replace("_spec", "_phase")
            jp = np.load(os.path.join(jtar, folder, ph))
            tp = np.load(os.path.join(ttar, folder, ph))
            assert tm.dtype == np.float32 and tp.dtype == np.complex64
            assert tm.shape == jm.shape == tp.shape
            np.testing.assert_allclose(tm, jm, atol=1e-5)
            np.testing.assert_allclose(tm * tp, jm * jp, atol=1e-5)


@pytest.mark.parametrize("mode", ["segments", "whole", "overlap"])
def test_separate_then_to_wave_matches(specs, weights, mode, tmp_path):
    _, jtar, ttar = specs
    jcfg, params, state, model = weights
    jout, tout = str(tmp_path / "jmask"), str(tmp_path / "tmask")
    os.makedirs(jout)
    os.makedirs(tout)
    names = sorted(f for f in os.listdir(os.path.join(jtar, "mixture"))
                   if f.endswith("_spec.npy"))
    for name in names:
        jmix = np.load(os.path.join(jtar, "mixture", name))
        tmix = np.load(os.path.join(ttar, "mixture", name))
        jm = jsep.separate_magnitude(params, state, jmix, cfg=jcfg, mode=mode)
        tm = tsep.separate_magnitude(model, tmix, mode=mode, device="cpu")
        assert tm.shape == jm.shape == jmix.shape
        assert (tm[0] == 0).all()
        np.testing.assert_allclose(tm, jm, atol=1e-5)
        np.save(os.path.join(jout, name), jm)
        np.save(os.path.join(tout, name), tm)
    if mode != "segments":
        return
    jwav, twav_dir = str(tmp_path / "jwav"), str(tmp_path / "twav")
    assert jprep.to_wave(jout, jwav, jtar, progress=False, **GEOM) == 2
    assert tprep.to_wave(tout, twav_dir, ttar, progress=False, device="cpu",
                         **GEOM) == 2
    for name in sorted(os.listdir(jwav)):
        with open(os.path.join(jwav, name), "rb") as f:
            jb = f.read()
        with open(os.path.join(twav_dir, name), "rb") as f:
            tb = f.read()
        assert jb[:44] == tb[:44]  # same RIFF header, so same length
        ji = np.frombuffer(jb[44:], "<i2").astype(np.int32)
        ti = np.frombuffer(tb[44:], "<i2").astype(np.int32)
        assert np.abs(ji - ti).max() <= 2


def test_random_phase_fallback_matches(tmp_path):
    spec_dir = tmp_path / "specs"
    os.makedirs(spec_dir)
    np.save(str(spec_dir / "0000_x_spec.npy"),
            np.random.default_rng(0).random((513, 40)).astype(np.float32))
    outs = []
    for pkg, kw in ((jprep, {}), (tprep, {"device": "cpu"})):
        out = str(tmp_path / pkg.__name__)
        assert pkg.to_wave(str(spec_dir), out, str(tmp_path / "none"),
                           progress=False, seed=0, **GEOM, **kw) == 1
        outs.append(twav.read_wav(os.path.join(out, "0000_x.wav"))[0])
    np.testing.assert_allclose(outs[0], outs[1], atol=2 / 32768)


def test_separate_wav_both_matches(weights):
    jcfg, params, state, model = weights
    rng = np.random.default_rng(1)
    y, _ = _song(rng, 9.5)
    jv, ja = jsep.separate_wav(params, state, y, both=True, cfg=jcfg)
    tv, ta = tsep.separate_wav(model, y, both=True, device="cpu")
    assert tv.shape == ta.shape == y.shape
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    np.testing.assert_allclose(ta, ja, atol=1e-5)
    # complementary masks: vocal + accompaniment reconstruct the mixture
    covered = 768 * (len(y) // 768) - 1024
    np.testing.assert_allclose((tv + ta)[1024:covered], y[1024:covered],
                               atol=1e-4)


def test_prep_kernel_impl_matches_pallas():
    """impl='kernel' on the CPU (the kernel's plain version) against
    svs_tpu's impl='pallas' (the Pallas kernel in interpret mode)."""
    y = (np.random.default_rng(2).standard_normal(3 * SR) * 0.2).astype(
        np.float32)
    jm, jp = jprep.stft_magphase(y, 1024, 768, impl="pallas")
    tm, tp = tprep.stft_magphase(y, 1024, 768, impl="kernel", device="cpu")
    assert tm.shape == jm.shape and tp.shape == jp.shape
    np.testing.assert_allclose(tm, jm, atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(tm * tp, jm * jp, atol=2e-3)


def test_clis_default_preset_on_cpu(tmp_path, capsys):
    """The three CLIs of the port at the full-width default preset."""
    src = _make_songs(str(tmp_path / "songs"), seconds=(3.0,), seed=3)
    spec = str(tmp_path / "spec")
    assert t_data_cli.main(["--src", src, "--tar", spec, "--device",
                            "cpu"]) == 0
    pth = str(tmp_path / "w.pth")
    t_import.save_pth(pth, UNet(get_config("default"),
                                generator=torch.Generator().manual_seed(0)))
    masked = str(tmp_path / "masked")
    assert t_infer_cli.main([
        "--model_path", pth, "--tar", masked, "--mixture_folder",
        os.path.join(spec, "mixture"), "--preset", "default",
        "--device", "cpu"]) == 0
    out = str(tmp_path / "wav")
    assert t_data_cli.main(["--src", masked, "--tar", out, "--phase", spec,
                            "--direction", "to_wave", "--device",
                            "cpu"]) == 0
    mag = np.load(os.path.join(masked, "0000_song0_spec.npy"))
    assert mag.shape == (513, 1 + 3 * SR // 768) and np.isfinite(mag).all()
    y, sr = twav.read_wav(os.path.join(out, "0000_song0.wav"))
    assert sr == SR and len(y) == 768 * (mag.shape[1] - 1)
    assert np.isfinite(y).all() and np.abs(y).max() <= 0.9 + 1e-4


def test_separate_refuses_a_model_on_another_device(weights):
    """A model left on the host is not run there unless device='cpu'."""
    model = weights[3]
    with pytest.raises(ValueError, match="the model is on cpu"):
        tsep.separate_wav(model, np.zeros(8192, np.float32), device="meta")


def test_native_ckpt_is_refused(tmp_path, capsys):
    """infer_cli once refused svs_tpu's native ``.ckpt``; the checkpoint
    slice loads it (svs_torch.train.checkpoint.resume, weights only): a
    written one separates, and a missing one fails with exit code 1."""
    from svs_torch.train import checkpoint as tckpt
    from svs_torch.train.step import create_train_state

    (tmp_path / "m").mkdir()
    rc = t_infer_cli.main(["--model_path", str(tmp_path / "x.ckpt"),
                           "--tar", str(tmp_path / "o"), "--mixture_folder",
                           str(tmp_path / "m"), "--device", "cpu"])
    assert rc == 1
    assert "Failed to load model" in capsys.readouterr().out
    tckpt.save(str(tmp_path / "x.ckpt"),
               create_train_state(0, get_config("default"), device="cpu"))
    rc = t_infer_cli.main(["--model_path", str(tmp_path / "x.ckpt"),
                           "--tar", str(tmp_path / "o"), "--mixture_folder",
                           str(tmp_path / "m"), "--device", "cpu"])
    assert rc == 0


def test_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    """No GPU and no device='cpu': raise, never run quietly on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = np.zeros(8192, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.stft_magphase(y, 1024, 768)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.to_spec(str(tmp_path), str(tmp_path / "o"), progress=False,
                      **GEOM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_data_cli.main(["--src", str(tmp_path), "--tar",
                         str(tmp_path / "o")])
    model = UNet(TConfig(**NARROW)).eval()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsep.separate_wav(model, y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsep.separate_magnitude(model, np.zeros((513, 8), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_infer_cli.main(["--model_path", "w.pth", "--tar",
                          str(tmp_path / "o"), "--mixture_folder",
                          str(tmp_path)])


def test_port_imports_neither_jax_nor_svs_tpu():
    """svs_torch and chip_smoke.py stand alone (scanned as source text)."""
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "svs_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|ml_dtypes|msgpack|"
                     r"svs_tpu)\b", re.M)
    for path in files:
        with open(path) as f:
            assert not bad.search(f.read()), path

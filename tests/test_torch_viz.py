"""The port's diagnostics against svs_tpu's, on the CPU.

- ``amplitude_to_db`` against svs_tpu's on the same magnitudes (zeros, a
  span of 1e-9..10, and a complex spectrum), over ``ref``, ``amin`` and
  ``top_db``: 1e-5 relative plus 1e-5 dB (float32 log10 on two backends);
- ``parse_loss_log`` against svs_tpu's on the same log text: equal;
- each plotting entry point writes a PNG, and without matplotlib the module
  still imports, ``parse_loss_log`` works and a plotting call raises an
  ImportError that names matplotlib.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from svs_torch.cli import lossplot_cli, viz_cli
from svs_torch.models import torch_import as t_import
from svs_torch.models.unet import UNet
from svs_torch.ops import stft as tdsp
from svs_torch.utils import config as tconfig
from svs_torch.utils import viz as tviz
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.ops import stft as jdsp
from svs_tpu.utils import viz as jviz

NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16))
LOG = "3.0\n2.0\nVal 2.5\n1.0\n"


def _magnitudes(complex_input: bool):
    rng = np.random.default_rng(0)
    mag = (10.0 ** rng.uniform(-9, 1, (64, 40))).astype(np.float32)
    mag[:, :3] = 0.0
    if not complex_input:
        return mag
    phase = rng.uniform(-np.pi, np.pi, mag.shape)
    return (mag * np.exp(1j * phase)).astype(np.complex64)


@pytest.mark.parametrize("top_db", [80.0, None])
@pytest.mark.parametrize("amin", [1e-5, 1e-3])
@pytest.mark.parametrize("ref", [1.0, 0.37, 1e-7])
def test_amplitude_to_db_matches_jax(ref, amin, top_db):
    for complex_input in (False, True):
        s = _magnitudes(complex_input)
        want = np.asarray(jdsp.amplitude_to_db(s, ref=ref, amin=amin,
                                               top_db=top_db))
        got = tdsp.amplitude_to_db(torch.from_numpy(s), ref=ref, amin=amin,
                                   top_db=top_db)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("text", [
    "1.5\n2.5\nVal 9.0\n3.5\nnot-a-number\nVal 8.0\n\n",
    "Val 4.0\n\n  \n2.0\nVal oops\nVal 1.0\n1e-3\n",
    "",
], ids=["val_lines", "val_first_blank_malformed", "empty"])
def test_parse_loss_log_matches_jax(tmp_path, text):
    p = str(tmp_path / "log.txt")
    with open(p, "w") as f:
        f.write(text)
    assert tviz.parse_loss_log(p) == jviz.parse_loss_log(p)


def _narrow_pth(tmp_path, monkeypatch):
    monkeypatch.setitem(tconfig.PRESETS, "narrow", TConfig(**NARROW))
    pth = str(tmp_path / "narrow.pth")
    model = UNet(TConfig(**NARROW), generator=torch.Generator().manual_seed(0))
    t_import.save_pth(pth, model)
    return pth


def _spectra(tmp_path):
    """A 128-frame mixture spectrum and its vocal, viz_cli's file layout."""
    rng = np.random.default_rng(1)
    paths = {}
    for folder in ("mixture", "vocal"):
        os.makedirs(tmp_path / folder, exist_ok=True)
        paths[folder] = str(tmp_path / folder / "0000_song0_spec.npy")
        np.save(paths[folder],
                np.abs(rng.standard_normal((513, 128))).astype(np.float32))
    return paths


def test_plots_write_pngs(tmp_path, monkeypatch):
    spec = _spectra(tmp_path)
    mix, voc = np.load(spec["mixture"]), np.load(spec["vocal"])
    out = str(tmp_path / "debug.png")
    assert tviz.debug_figure(mix, voc, voc * 0.5, out) == out
    assert os.path.getsize(out) > 10000

    log = str(tmp_path / "log.txt")
    with open(log, "w") as f:
        f.write(LOG)
    out = str(tmp_path / "loss.png")
    assert tviz.plot_losses(log, out) == out and os.path.getsize(out) > 1000
    empty = str(tmp_path / "empty.txt")
    open(empty, "w").close()
    assert tviz.plot_losses(empty, str(tmp_path / "none.png")) is None

    out = str(tmp_path / "lossplot_cli.png")
    assert lossplot_cli.main([log, "--out", out]) == 0
    assert os.path.getsize(out) > 1000

    out = str(tmp_path / "viz_cli.png")
    rc = viz_cli.main(["--model_path", _narrow_pth(tmp_path, monkeypatch),
                       "--spec_path", spec["mixture"], "--out", out,
                       "--preset", "narrow", "--device", "cpu"])
    assert rc == 0 and os.path.getsize(out) > 10000


def test_without_matplotlib_plotting_raises_and_parsing_works(
        tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "svs_torch.utils.viz")
    viz = importlib.import_module("svs_torch.utils.viz")

    log = str(tmp_path / "log.txt")
    with open(log, "w") as f:
        f.write(LOG)
    assert viz.parse_loss_log(log) == ([3.0, 2.0, 1.0], [2.5], [2])
    with pytest.raises(ImportError, match="matplotlib"):
        viz.plot_losses(log, str(tmp_path / "loss.png"))
    spec = _spectra(tmp_path)
    mix = np.load(spec["mixture"])
    with pytest.raises(ImportError, match="matplotlib"):
        viz.debug_figure(mix, mix, mix, str(tmp_path / "debug.png"))
    out = str(tmp_path / "viz_cli.png")
    with pytest.raises(ImportError, match="matplotlib"):
        viz_cli.main(["--model_path", _narrow_pth(tmp_path, monkeypatch),
                      "--spec_path", spec["mixture"], "--out", out,
                      "--preset", "narrow", "--device", "cpu"])
    assert not os.path.exists(out)

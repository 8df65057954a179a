"""The port's stream and PCM16 decode against svs_tpu's, on the CPU.

The same narrow float32 weights go to both packages (svs_tpu ``unet.init``
-> ``state_dict_from_jax``); three songs of 2-4 s.  Tolerances:
- f32 stream against svs_tpu's stream: 1e-5 (the slice's waveform bound for
  f32 FFTs and U-Nets summed in different orders);
- stream against the port's own ``separate_wav``: 1e-6, the bound of
  tests/test_stream.py (the same program, song by song);
- PCM16 against svs_tpu's PCM16: 1 LSB (values that agree to 1e-5 can round
  one code apart); against the f32 path: 2 LSB (tests/test_stream.py:35-36).
"""

import numpy as np
import pytest

import jax

from svs_torch.infer import separate as tsep
from svs_torch.models import torch_import as t_import
from svs_torch.models.unet import UNet
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.infer import separate as jsep
from svs_tpu.models import unet as junet
from svs_tpu.utils.config import SVSConfig as JConfig

SR = 8192
NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16))


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
def songs():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(SR * (2 + i) + 137 * i) * 0.1).astype(
        np.float32) for i in range(3)]


def test_stream_matches_jax_and_single(weights, songs):
    jcfg, params, state, model = weights
    want = jsep.separate_wav_stream(params, state, songs, cfg=jcfg)
    got = tsep.separate_wav_stream(model, songs, device="cpu")
    assert [len(o) for o in got] == [len(s) for s in songs]
    for y, o, w in zip(songs, got, want):
        assert o.dtype == np.float32
        np.testing.assert_allclose(o, w, atol=1e-5)
        single = tsep.separate_wav(model, y, device="cpu")
        np.testing.assert_allclose(o, single, atol=1e-6)


def test_pcm16_stream_matches_jax_and_f32(weights, songs):
    jcfg, params, state, model = weights
    y16 = [(y * 32768.0).clip(-32768, 32767).astype(np.int16)
           for y in songs[:2]]
    want = jsep.separate_wav_stream(params, state, y16, cfg=jcfg, pcm16=True)
    got = tsep.separate_wav_stream(model, y16, pcm16=True, device="cpu")
    for y, o, w in zip(y16, got, want):
        assert o.dtype == np.int16 and o.shape == y.shape
        assert np.abs(o.astype(np.int32) - w.astype(np.int32)).max() <= 1
        o32 = tsep.separate_wav(model, y.astype(np.float32) / 32768.0,
                                device="cpu")
        np.testing.assert_allclose(o.astype(np.float32) / 32768.0, o32,
                                   atol=2.0 / 32768.0)


def test_stream_refuses_a_model_in_train_mode(weights, songs):
    model = weights[3]
    model.train()
    try:
        with pytest.raises(ValueError, match="eval mode"):
            tsep.separate_wav_stream(model, songs[:1], device="cpu")
    finally:
        model.eval()

"""The benchmark's plain reference against the program, at tiny sizes on the
CPU in float32, and the FLOP count against a hand count."""

import ast
import glob
import os

import numpy as np
import pytest
import torch

from portbench import compare, flops, run as harness, tiny, weights
from portbench.reference import decode as ref_decode, dsp, train as ref_train
from portbench.reference import unet

CFG = tiny.config()


def _program_config():
    return harness.svs_config(CFG)


def _params(seed=3):
    return weights.make(seed, CFG["enc_channels"], "cpu")


def _model(params, cfg=None):
    from svs_torch.models.unet import UNet
    model = UNet(cfg or _program_config())
    weights.load_into(model, params)
    return model


def _mags(b=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, CFG["freq_bins"], CFG["input_len"], generator=g)


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(os.path.dirname(__file__),
                                       "reference", "*.py")):
        tree = ast.parse(open(path).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"svs_torch", "svs_tpu", "jax", "flax", "optax"}, \
            path


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_program(train):
    params = _params()
    x = _mags()
    weights.calibrate(params, x, CFG["bn_eps"])
    model = _model(params).train(train)
    keeps = None
    gen = torch.Generator().manual_seed(9)
    if train:
        keeps = unet.dropout_keeps(3, CFG["enc_channels"],
                                   torch.Generator().manual_seed(9), "cpu")
    with torch.no_grad():
        got = model(x, generator=gen if train else None)
        want = unet.forward(params, x, train=train, keeps=keeps)
    assert torch.allclose(got, want, atol=2e-6), (got - want).abs().max()


@pytest.mark.parametrize("pad_mode", ["constant", "reflect"])
def test_stft_and_istft_match_program(pad_mode):
    from svs_torch.ops import stft as prog
    y = torch.randn(2, 5000, generator=torch.Generator().manual_seed(1))
    got = prog.stft(y, n_fft=256, hop_length=64, win_length=200,
                    pad_mode=pad_mode)
    want = dsp.stft(y, 256, 64, 200, pad_mode=pad_mode)
    assert torch.allclose(got, want, atol=1e-4)
    s = dsp.stft(y, 256, 64)
    back = prog.istft(s, hop_length=64, win_length=256, n_fft=256,
                      length=5000)
    assert torch.allclose(back, dsp.istft(s, 256, 64, length=5000),
                          atol=1e-5)


def test_loss_matches_program():
    from svs_torch.losses.mrstft import combined_loss
    g = torch.Generator().manual_seed(2)
    shape = (2, CFG["freq_bins"], CFG["input_len"])
    mix, voc = torch.rand(shape, generator=g), torch.rand(shape, generator=g)
    ang = [(torch.rand(shape, generator=g) - 0.5) * 6 for _ in range(2)]
    mask = torch.rand(shape, generator=g)
    got, aux = combined_loss(mask, mix, voc, *ang, _program_config())
    want, l1, mr = dsp.combined_loss(mask, mix, voc, *ang, CFG)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert abs(float(aux["mr"]) - float(mr)) <= 1e-5 * abs(float(mr))


def test_train_steps_match_program():
    from svs_torch.train.step import create_train_state, make_step_fn
    params = _params(4)
    cfg = _program_config()
    state = create_train_state(0, cfg, device="cpu")
    weights.load_into(state.model, params)
    step = make_step_fn(cfg)
    gen_p, gen_r = (torch.Generator().manual_seed(5) for _ in range(2))
    ref = {k: v.clone() for k, v in params.items()}
    opt = ref_train.Adam(ref, ref_train.trainable(ref), CFG["learning_rate"])
    g = torch.Generator().manual_seed(6)
    for _ in range(2):
        shape = (4, CFG["freq_bins"], CFG["input_len"])
        batch = {"mix": torch.rand(shape, generator=g),
                 "voc": torch.rand(shape, generator=g) * 0.5,
                 "mix_angle": (torch.rand(shape, generator=g) - 0.5) * 6,
                 "voc_angle": (torch.rand(shape, generator=g) - 0.5) * 6}
        state, aux = step(state, batch, gen_p)
        keeps = unet.dropout_keeps(4, CFG["enc_channels"], gen_r, "cpu")
        loss, grads = ref_train.step(ref, opt, batch, keeps, CFG)
        assert abs(float(aux["total"]) - loss) <= 1e-5 * abs(loss)
    # a conv bias ahead of a train-mode BatchNorm has a gradient of
    # round-off, which Adam's normalisation turns into a step of either
    # sign: the leaves compare.moving leaves out
    got = dict(state.model.named_parameters())
    live = compare.moving(grads)
    assert len(live) == len(opt.names) - 11
    for k in live:
        assert torch.allclose(got[k], ref[k], atol=1e-5), k


@pytest.mark.parametrize("pcm16", [False, True])
def test_decode_matches_program(pcm16):
    from svs_torch.infer.separate import separate_wav_stream
    params = _params(7)
    rng = np.random.default_rng(0)
    y = (rng.standard_normal(20000) * 0.2).astype(np.float32)
    if pcm16:
        y = np.clip(np.round(y * 32768), -32768, 32767).astype(np.int16)
    weights.calibrate(params, ref_decode.segments_of(y, CFG, "cpu"),
                      CFG["bn_eps"])
    model = _model(params).eval()
    got, = separate_wav_stream(model, [y], pcm16=pcm16, device="cpu")
    want = ref_decode.separate(params, y, CFG, "cpu")
    assert got.dtype == want.dtype == y.dtype
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= (1 if pcm16 else 1e-5)


def test_flops_match_the_hand_count():
    # the default patch (512 x 128): encoder convs 13.1M + 5 x 104.9M,
    # decoder 104.9M + 4 x 209.7M + 26.2M MACs x 2 = 1.507 GFLOP
    default = dict(freq_bins=512, input_len=128,
                   enc_channels=[16, 32, 64, 128, 256, 512])
    f = flops.for_config(default)
    enc = 2 * 25 * (1 * 16 * 256 * 64 + 16 * 32 * 128 * 32
                    + 32 * 64 * 64 * 16 + 64 * 128 * 32 * 8
                    + 128 * 256 * 16 * 4 + 256 * 512 * 8 * 2)
    dec = 2 * 25 * (512 * 256 * 8 * 2 + 512 * 128 * 16 * 4
                    + 256 * 64 * 32 * 8 + 128 * 32 * 64 * 16
                    + 64 * 16 * 128 * 32 + 32 * 1 * 256 * 64)
    assert f["forward"] == enc + dec == 1_507_328_000
    assert f["train"] == 3 * f["forward"] - 2 * 25 * 16 * 256 * 64
    assert flops.for_config(dict(default, input_len=1536))["forward"] == \
        12 * f["forward"]


def test_flops_match_the_convs_of_a_traced_forward():
    """The count equals torch's FLOP counter over the reference's convs."""
    from torch.utils.flop_counter import FlopCounterMode
    params = _params()
    with FlopCounterMode(display=False) as counter:
        unet.forward(params, _mags(2), train=False)
    convs = sum(v for k, v in counter.get_flop_counts()["Global"].items()
                if "conv" in str(k))
    assert convs == 2 * flops.forward_flops(
        CFG["freq_bins"], CFG["input_len"], CFG["enc_channels"])


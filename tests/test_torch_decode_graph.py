"""The decode's cached programs (``svs_torch/infer/graphs.py``) on the CPU.

On the card ``separate_magnitude``, ``separate_wav`` and
``separate_wav_stream`` run a cached captured program per key.  Here the
entry points are routed through the same program objects (the ``routed``
fixture patches ``separate._programmed``), whose capture is skipped on the
CPU, so the key, the static input, the copy in, the copy out, the slice,
the PCM16 quantisation and the ``both`` tuple all run.  The same narrow
float32 weights go to both packages (svs_tpu ``unet.init`` ->
``state_dict_from_jax``).  Tolerances:
- against svs_tpu: 1e-5 in float32 (tests/test_torch_stream.py's bound for
  f32 FFTs and U-Nets summed in different orders), 1 LSB in PCM16;
- against the port's eager body (``_separate_padded``, ``_separate_spec``):
  the same bits, as the body is what the program runs.
"""

import copy
import gc
import os

import numpy as np
import pytest
import torch

import jax

from svs_torch.infer import graphs
from svs_torch.infer import separate as tsep
from svs_torch.models import torch_import as t_import
from svs_torch.models.unet import UNet
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.infer import separate as jsep
from svs_tpu.models import unet as junet
from svs_tpu.utils.config import SVSConfig as JConfig

SR = 8192
NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16))
MODES = ("segments", "overlap", "whole")


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


@pytest.fixture
def routed(monkeypatch):
    """The entry points on the CPU through a fresh cache of programs."""
    cache = graphs.ProgramCache()
    monkeypatch.setattr(tsep, "_programmed", lambda dev: True)
    monkeypatch.setattr(graphs, "CACHE", cache)
    return cache


def _padded(y, cfg, dtype=torch.float32):
    n = len(y)
    return torch.from_numpy(np.pad(y, (0, tsep._padded_len(n, cfg) - n))
                            ).to(dtype)


def _eager(model, y, *, vocal_solo=True, both=False, mode="segments"):
    """The eager body on the padded song, cut to the song."""
    with torch.inference_mode():
        out = tsep._separate_padded(model, _padded(y, model.cfg), model.cfg,
                                    vocal_solo, both, mode)
    if both:
        return tuple(o[:len(y)].numpy() for o in out)
    return out[:len(y)].numpy()


@pytest.mark.parametrize("vocal_solo", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_programs_match_svs_tpu_and_the_eager_body(weights, songs, routed,
                                                   mode, vocal_solo):
    jcfg, params, state, model = weights
    y = songs[0]
    got = tsep.separate_wav(model, y, vocal_solo=vocal_solo, mode=mode,
                            device="cpu")
    want = jsep.separate_wav(params, state, y, vocal_solo=vocal_solo,
                             cfg=jcfg, mode=mode)
    assert got.shape == y.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(
        got, _eager(model, y, vocal_solo=vocal_solo, mode=mode))

    # the stream over two songs of one bucket: the same program twice
    stream = tsep.separate_wav_stream(model, songs[:2], vocal_solo=vocal_solo,
                                      mode=mode, device="cpu")
    jstream = jsep.separate_wav_stream(params, state, songs[:2],
                                       vocal_solo=vocal_solo, cfg=jcfg,
                                       mode=mode)
    for s, o, w in zip(songs, stream, jstream):
        np.testing.assert_allclose(o, w, atol=1e-5)
        np.testing.assert_array_equal(
            o, _eager(model, s, vocal_solo=vocal_solo, mode=mode))

    # the magnitude program, at a frame count that is no bucket's
    mag = np.abs(np.random.default_rng(1).standard_normal(
        (513, 300))).astype(np.float32)
    got_m = tsep.separate_magnitude(model, mag, vocal_solo=vocal_solo,
                                    mode=mode, device="cpu")
    want_m = jsep.separate_magnitude(params, state, mag,
                                     vocal_solo=vocal_solo, cfg=jcfg,
                                     mode=mode)
    assert got_m.shape == mag.shape
    np.testing.assert_allclose(got_m, want_m, atol=1e-5)
    t_pad = 8 * model.cfg.input_len
    with torch.inference_mode():
        eager_m = tsep._separate_spec(
            model, torch.from_numpy(np.pad(mag, ((0, 0), (0, t_pad - 300)))),
            model.cfg, vocal_solo, mode)[:, :300].numpy()
    np.testing.assert_array_equal(got_m, eager_m)
    # one program each: the wav (separate_wav and the stream) and the spec
    assert routed.builds == len(routed) == 2


def test_both_program_matches_svs_tpu_and_the_eager_body(weights, songs,
                                                         routed):
    jcfg, params, state, model = weights
    y = songs[1]
    vocal, accomp = tsep.separate_wav(model, y, both=True, device="cpu")
    jv, ja = jsep.separate_wav(params, state, y, both=True, cfg=jcfg)
    np.testing.assert_allclose(vocal, jv, atol=1e-5)
    np.testing.assert_allclose(accomp, ja, atol=1e-5)
    ev, ea = _eager(model, y, both=True)
    np.testing.assert_array_equal(vocal, ev)
    np.testing.assert_array_equal(accomp, ea)
    assert routed.builds == 1


def test_pcm16_program_matches_svs_tpu_and_the_eager_body(weights, songs,
                                                          routed):
    jcfg, params, state, model = weights
    y16 = [(y * 32768.0).clip(-32768, 32767).astype(np.int16)
           for y in songs[:2]]
    got = tsep.separate_wav_stream(model, y16, pcm16=True, device="cpu")
    want = jsep.separate_wav_stream(params, state, y16, cfg=jcfg, pcm16=True)
    for y, o, w in zip(y16, got, want):
        assert o.dtype == np.int16 and o.shape == y.shape
        assert np.abs(o.astype(np.int32) - w.astype(np.int32)).max() <= 1
        with torch.inference_mode():
            e = tsep._separate_padded_pcm16(
                model, _padded(y, model.cfg, torch.int16), model.cfg, True,
                "segments")[:len(y)].numpy()
        np.testing.assert_array_equal(o, e)
    assert routed.builds == 1


def test_a_result_never_aliases_the_programs_buffers(weights, songs,
                                                     routed):
    """Two songs of one key in a row each get their own answer, and the
    second call leaves the first result as it was."""
    model = weights[3]
    a = tsep.separate_wav(model, songs[0], device="cpu")
    kept = a.copy()
    b = tsep.separate_wav(model, songs[1], device="cpu")
    np.testing.assert_array_equal(a, kept)
    np.testing.assert_array_equal(b, _eager(model, songs[1]))
    assert routed.builds == 1

    # the program itself: fresh tensors, never its static buffers
    (prog,) = routed._programs.values()
    x1, x2 = _padded(songs[0], model.cfg), _padded(songs[1], model.cfg)
    (first,) = prog(x1)
    before = first.clone()
    (second,) = prog(x2)
    assert torch.equal(first, before) and not torch.equal(first, second)
    assert first.data_ptr() != second.data_ptr()
    assert prog.input.data_ptr() not in (first.data_ptr(),
                                         second.data_ptr())


def test_alternating_keys_build_two_programs_and_reuse_them(weights, songs,
                                                            routed):
    model = weights[3]
    for _ in range(3):
        for mode in ("segments", "whole"):
            tsep.separate_wav(model, songs[0], mode=mode, device="cpu")
    assert routed.builds == len(routed) == 2


def test_a_rebound_model_gets_a_new_program(weights, songs, routed):
    model = copy.deepcopy(weights[3])
    y = songs[0]
    tsep.separate_wav(model, y, device="cpu")
    scaled = {k: v * 0.5 if v.is_floating_point() else v
              for k, v in model.state_dict().items()}
    model.load_state_dict(scaled, assign=True)  # new tensors, new addresses
    got = tsep.separate_wav(model, y, device="cpu")
    assert routed.builds == 2 and len(routed) == 1  # the stale one went
    np.testing.assert_array_equal(got, _eager(model, y))
    assert not np.array_equal(got, _eager(weights[3], y))
    # weights changed in place keep their addresses and their program
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(2.0)
    got = tsep.separate_wav(model, y, device="cpu")
    assert routed.builds == 2
    np.testing.assert_array_equal(got, _eager(model, y))


@pytest.mark.parametrize("flags,name", [
    (torch.backends.cudnn, "allow_tf32"),
    (torch.backends.cuda.matmul, "allow_tf32"),
    (torch.backends.cudnn, "deterministic"),
    (torch.backends.cudnn, "benchmark")])
def test_a_changed_algorithm_flag_gets_a_new_program(weights, songs, routed,
                                                     monkeypatch, flags,
                                                     name):
    """The graph bakes in the algorithms these flags choose."""
    model = weights[3]
    tsep.separate_wav(model, songs[0], device="cpu")
    monkeypatch.setattr(flags, name, not getattr(flags, name))
    tsep.separate_wav(model, songs[0], device="cpu")
    assert routed.builds == 2 and len(routed) == 1


def test_the_least_recently_used_program_goes_past_the_bound(weights, songs,
                                                            routed):
    model = weights[3]
    x = _padded(songs[0], model.cfg)
    per = x.nbytes  # a CPU program holds its static input
    cache = graphs.ProgramCache(max_bytes=2 * per)
    signatures = {m: tsep._wav_body(model.cfg, True, False, m, False)
                  for m in MODES}

    def use(mode):
        sig, body = signatures[mode]
        return cache.program(model, sig, x, body)

    a = use("segments")
    use("overlap")
    assert use("segments") is a  # a hit, and now the most recent
    use("whole")  # past the bound: "overlap" was used least recently
    assert cache.evictions == 1 and cache.nbytes == 2 * per
    assert {k[1][1] for k in cache._programs} == {"segments", "whole"}
    assert use("segments") is a and cache.builds == 3
    # the newest stays even when it alone passes the bound
    small = graphs.ProgramCache(max_bytes=per // 2)
    sig, body = signatures["whole"]
    small.program(model, sig, x, body)
    assert len(small) == 1 and small.evictions == 0


def test_a_freed_models_programs_are_dropped(weights, songs, routed):
    other = copy.deepcopy(weights[3])
    tsep.separate_wav(other, songs[0], device="cpu")
    assert len(routed) == 1
    del other
    gc.collect()
    tsep.separate_wav(weights[3], songs[0], device="cpu")
    assert len(routed) == 1 and routed.builds == 2


def _hammer(worker, n_threads):
    """Run ``worker(k)`` on ``n_threads`` threads with the interpreter
    switching threads often; returns the errors they raised."""
    import sys
    import threading

    errors = []

    def run(k):
        try:
            worker(k)
        except Exception as e:  # reported in the test's thread
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_threads_sharing_the_programs_each_get_their_own_answer(
        weights, songs, routed):
    """More threads than cores call the programs at once.  A program whose
    body reads its static input slowly (as the card reads it after the
    copy-in) gives each caller its own input's answer, so no copy-in lands
    inside another call; and through the entry points every answer is its
    own song's eager decode, each key built once."""
    import time

    n_threads = 2 * (os.cpu_count() or 4)
    model = weights[3]

    def slow(model, y):
        time.sleep(0.001)
        return (y * 2.0,)

    prog = graphs.Program(model, slow, torch.zeros(64), torch.device("cpu"))
    bad = []

    def direct(k):
        for r in range(5):
            x = torch.full((64,), float(100 * k + r))
            if not torch.equal(prog(x)[0], x * 2.0):
                bad.append((k, r))

    assert not _hammer(direct, n_threads) and not bad, bad

    modes = ("segments", "whole")
    want = {(i, m): _eager(model, songs[i], mode=m)
            for i in range(2) for m in modes}

    def entry(k):
        for r in range(2):
            i, m = (k + r) % 2, modes[k % 2]
            got = tsep.separate_wav(model, songs[i], mode=m, device="cpu")
            if not np.array_equal(got, want[(i, m)]):
                bad.append((k, i, m))

    assert not _hammer(entry, n_threads) and not bad, bad
    assert routed.builds == len(routed) == 2


def test_the_cpu_entry_points_stay_eager(weights, songs, monkeypatch):
    cache = graphs.ProgramCache()
    monkeypatch.setattr(graphs, "CACHE", cache)
    model = weights[3]
    got = tsep.separate_wav(model, songs[0], device="cpu")
    tsep.separate_wav_stream(model, songs[:1], device="cpu")
    tsep.separate_magnitude(model, np.ones((513, 40), np.float32),
                            device="cpu")
    assert cache.builds == 0
    np.testing.assert_array_equal(got, _eager(model, songs[0]))

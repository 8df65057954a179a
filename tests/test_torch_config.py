"""The port's config equals svs_tpu's, field by field, for every preset."""

import dataclasses

import pytest

from svs_torch.utils import config as tc
from svs_tpu.utils import config as jc


def test_preset_names_match():
    assert sorted(tc.PRESETS) == sorted(jc.PRESETS)


@pytest.mark.parametrize("name", sorted(jc.PRESETS))
def test_preset_fields_match(name):
    want = dataclasses.asdict(jc.get_config(name))
    got = dataclasses.asdict(tc.get_config(name))
    assert got == want
    assert tc.get_config(name).n_fft_bins == jc.get_config(name).n_fft_bins


def test_default_config_and_constants_match():
    assert dataclasses.asdict(tc.SVSConfig()) == dataclasses.asdict(
        jc.SVSConfig())
    for const in ("WINDOW_SIZE", "HOP_SIZE", "SAMPLE_RATE", "INPUT_LEN",
                  "SAMPLES_PER_SONG"):
        assert getattr(tc, const) == getattr(jc, const)
    for n in (0, 7, 123, 4567):
        assert tc.num2str(n) == jc.num2str(n)

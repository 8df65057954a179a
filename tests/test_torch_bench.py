"""The port's bench surface on the CPU (svs_torch/utils/benchmark.py and
the bench CLI), mirroring tests/test_bench.py with ``device="cpu"`` at a
narrow float32 width.  The card's numbers come from ``chip_smoke.py``."""

import dataclasses
import functools
import json
import math

import numpy as np
import pytest
import threadpoolctl
import torch

from svs_torch.cli import bench_cli
from svs_torch.utils import benchmark as bm
from svs_torch.utils.config import SVSConfig

NARROW = dataclasses.replace(SVSConfig(), enc_channels=(4, 8, 8, 16, 16, 16),
                             input_len=64, samples_per_song=4)


@pytest.fixture(autouse=True)
def one_thread():
    """One OpenMP thread (torch's intra-op pool) while a case runs,
    restored after it: Tier-1 runs six test files at once on eight cores,
    where a thread a core in each oversubscribes the CPU several times
    over.  Set through threadpoolctl: ``torch.set_num_threads`` also sets
    MKL's count, and once it has, MKL's float64 solve in ``bss_torch``
    hangs."""
    with threadpoolctl.threadpool_limits(1, user_api="openmp"):
        yield


@pytest.mark.parametrize("impl", ["fft", "matmul_bf16", "pallas_fused"])
def test_train_step_bench_fields(impl):
    cfg = dataclasses.replace(NARROW, mr_mag_impl=impl)
    out = bm.train_step_bench(cfg, batch_size=2, steps=2, device="cpu")
    assert out["train_batch"] == 2 and out["train_dtype"] == "float32"
    assert out["train_mr_mag_impl"] == impl
    assert out["train_step_ms"] > 0
    assert np.isfinite(out["train_steps_per_sec"])
    assert out["train_mfu_pct"] is None  # no peak for the CPU
    if impl == "pallas_fused":
        # the hand kernels are invisible to the FLOP counter
        assert out["train_flops_per_step"] is None
    else:
        # at least the convs' forward and backward of two patches
        assert out["train_flops_per_step"] > 1e7


def test_decode_device_bench_fields():
    out = bm.decode_device_bench(cfg=NARROW, secs=2.0, reps=2, device="cpu")
    assert out["decode_device_ms_per_song"] > 0
    assert out["decode_device_frames_per_sec"] > 0
    n_frames = 1 + int(NARROW.sample_rate * 2.0) // NARROW.hop_size
    want = n_frames / (out["decode_device_ms_per_song"] / 1e3)
    np.testing.assert_allclose(out["decode_device_frames_per_sec"], want,
                               rtol=0.01)


@pytest.mark.parametrize("resident", [False, True])
def test_train_epoch_bench_fields(resident):
    out = bm.train_epoch_bench(NARROW, batch_size=4, n_songs=2,
                               song_frames=150, epochs=1,
                               device_resident=resident, device="cpu")
    sfx = "_device" if resident else ""
    secs = out[f"train_epoch{sfx}_secs"]
    patches = out[f"train_epoch{sfx}_patches"]
    rate = out[f"train_patches_per_sec{sfx}"]
    assert patches == 8  # 2 songs x 4 per song
    # seconds are rounded to 2 decimals (svs_tpu's format; a fast epoch
    # reads 0.0) and the rate, from the unrounded seconds, to 1: the true
    # seconds lie within half a hundredth of the rounded ones
    assert secs >= 0 and rate > 0
    assert rate >= patches / (secs + 0.005) - 0.05
    if secs > 0.005:
        assert rate <= patches / (secs - 0.005) + 0.05


def test_epoch_scan_is_not_yet_ported():
    """The whole-epoch variant has come (train/scan.py, eager on the CPU):
    svs_tpu's ``_scan`` fields, 3 full steps of 2 and a tail a epoch."""
    out = bm.train_epoch_bench(NARROW, batch_size=3, n_songs=2,
                               song_frames=150, epochs=1, epoch_scan=True,
                               device="cpu")
    assert sorted(out) == ["train_epoch_scan_patches",
                           "train_epoch_scan_secs",
                           "train_patches_per_sec_scan"]
    assert out["train_epoch_scan_patches"] == 8
    assert out["train_patches_per_sec_scan"] > 0


def test_run_bench_line(monkeypatch):
    """The whole line at a narrow width (decode bursts cut to 2 calls); a
    failing sub-bench leaves an error field and the headline stands."""
    monkeypatch.setattr(bm, "decode_device_bench",
                        functools.partial(bm.decode_device_bench, reps=2))

    def broken(**kw):
        raise OSError("no link")

    monkeypatch.setattr(bm, "link_bandwidth_bench", broken)
    out = bm.run_bench(secs=2.0, reps=2, cfg=NARROW, train=False,
                       device="cpu")
    assert out["metric"] == "decode_device_frames_per_sec"
    assert out["value"] == out["decode_device_frames_per_sec"] > 0
    assert out["stream_frames_per_sec"] > 0 and out["stream_io"] == "pcm16"
    assert out["device"] == "cpu"
    assert "no link" in out["link_bench_error"]
    json.dumps(out)


def test_link_and_hbm_benches_on_the_cpu():
    link = bm.link_bandwidth_bench(mib=1, reps=2, device="cpu")
    assert link["link_probe_mib"] == 1 and link["link_h2d_mib_per_sec"] > 0
    assert bm.hbm_bandwidth_bench(mib=1, reps=2, device="cpu") > 0


def test_device_peak_flops_longest_prefix(monkeypatch):
    """The MFU denominator is found by the longest name prefix, whatever
    the table's order; None on the CPU and for an unknown card."""
    cuda = torch.device("cuda")

    def peak_for(kind, table=None):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: kind)
        if table is not None:
            monkeypatch.setattr(bm, "_PEAK_FLOPS", table)
        return bm._device_peak_flops(cuda)

    assert peak_for("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_for("NVIDIA H100 PCIe") == 756e12
    assert peak_for("NVIDIA A100-SXM4-80GB") is None
    assert bm._device_peak_flops("cpu") is None
    # a shorter name that prefixes a longer one never takes its place
    table = {"NVIDIA H100": 1.0, "NVIDIA H100 PCIe": 2.0,
             "NVIDIA H100 80GB HBM3": 3.0}
    for t in (table, dict(reversed(list(table.items())))):
        assert peak_for("NVIDIA H100 PCIe", t) == 2.0
        assert peak_for("NVIDIA H100 80GB HBM3", t) == 3.0
        assert peak_for("NVIDIA H100 NVL", t) == 1.0


def test_bench_cli_frontend_on_the_cpu(capsys):
    assert bench_cli.main(["--frontend", "--secs", "2", "--device",
                           "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "frontend_stft_ms"
    for key in ("mag_kernel_ms", "mag_torch_ms", "magphase_kernel_ms",
                "magphase_torch_ms"):
        assert out[key] >= 0 and math.isfinite(out[key])
    assert out["mag_max_abs_err"] < 2e-3
    assert out["magphase_max_abs_err"] < 2e-3


def test_bench_cli_dp_smoke_is_refused(capsys):
    """--dp-smoke refuses a rank count below one (its run on two ranks is
    tests/test_torch_dp_smoke.py's)."""
    assert bench_cli.main(["--dp-smoke", "--devices", "0"]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "nothing was run" in cap.err


def test_bench_cli_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--frontend", "--secs", "1"], ["--train"], []):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_cli.main(argv)

"""``bench_cli --dp-smoke`` (``svs_torch.parallel.dryrun``): the port's
multi-device dry run starts its own gloo ranks on the CPU, so it has a
module of its own (one process group a module).  At two ranks it prints
svs_tpu's JSON line with ``ok: true``: the DP step within
``__graft_entry__``'s envelope of the unsharded step, the ranks' states the
same bits, the SP decode within 2e-5 of the unsharded decode, the CP step
within the envelope and the whole-song CP decode within 3e-5 of the
unsharded whole decode, and the multi-host block (the ranks as 2 hosts)
within the envelope of the unsharded step of the host-major padded batch;
at four ranks also the TP block on a (2, 2) mesh."""

import json

import pytest
import threadpoolctl

from svs_torch.cli import bench_cli
from svs_torch.parallel import dryrun


@pytest.mark.parametrize("devices", [2, 4])
def test_bench_cli_dp_smoke_on_two_ranks(capsys, devices):
    # one OpenMP thread here while the ranks run (threadpoolctl, not
    # torch.set_num_threads, which also sets MKL's count for good)
    with threadpoolctl.threadpool_limits(1, user_api="openmp"):
        rc = bench_cli.main(["--dp-smoke", "--devices", str(devices)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert rc == 0, line
    assert sorted(line) == ["detail", "devices", "metric", "ok", "wall_s"]
    assert line["metric"] == "dp_smoke" and line["ok"] is True
    assert line["devices"] == devices and line["wall_s"] > 0
    for name in dryrun.CHECKED + dryrun.NOT_PORTED:
        assert repr(name) in line["detail"], name
    # the TP block: a (2, n / 2) mesh where n >= 4 is even, enc4's kernel
    # cut to 128 / (n / 2) output channels
    if devices == 4:
        assert "tp == unsharded step" in line["detail"]
        assert "enc4 weight / moment held [64, 64, 5, 5]" in line["detail"]
        assert "mesh (2, 2)" in line["detail"]
    else:
        assert "['tp'] skipped" in line["detail"]
    # the CP block: a batch of 2 x 64 n frames, 64 a rank, and the
    # whole-song decode of 512 frames (both decodes' padding at n <= 8)
    assert dryrun.NOT_PORTED == ()
    assert "cp == unsharded step" in line["detail"]
    assert f"B = 2 x {64 * devices} frames, 64 a rank" in line["detail"]
    assert "cp decode == unsharded whole decode" in line["detail"]
    assert "512 frames)" in line["detail"]
    # the multi-host block: 2 hosts of n / 2 ranks, a global batch of
    # n + 1 rows cut into hosts of ceil((n + 1) / 2) rows, the last padded
    assert "multihost == unsharded step of the host-major padded batch" \
        in line["detail"]
    local = -(-(devices + 1) // 2)
    assert (f"2 hosts of {devices // 2} ranks, host rows "
            f"[{local}, {devices + 1 - local}] padded to "
            f"{-(-local // (devices // 2)) * (devices // 2)})"
            in line["detail"])
    assert "not ported: []" in line["detail"]

"""``bench_cli --dp-smoke`` (``svs_torch.parallel.dryrun``): the port's
multi-device dry run starts its own gloo ranks on the CPU, so it has a
module of its own (one process group a module).  At two ranks it prints
svs_tpu's JSON line with ``ok: true``: the DP step within
``__graft_entry__``'s envelope of the unsharded step, the ranks' states the
same bits, and the SP decode within 2e-5 of the unsharded decode."""

import json

import threadpoolctl

from svs_torch.cli import bench_cli
from svs_torch.parallel import dryrun


def test_bench_cli_dp_smoke_on_two_ranks(capsys):
    # one OpenMP thread here while the ranks run (threadpoolctl, not
    # torch.set_num_threads, which also sets MKL's count for good)
    with threadpoolctl.threadpool_limits(1, user_api="openmp"):
        rc = bench_cli.main(["--dp-smoke", "--devices", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert rc == 0, line
    assert sorted(line) == ["detail", "devices", "metric", "ok", "wall_s"]
    assert line["metric"] == "dp_smoke" and line["ok"] is True
    assert line["devices"] == 2 and line["wall_s"] > 0
    for name in dryrun.CHECKED + dryrun.NOT_PORTED:
        assert repr(name) in line["detail"], name

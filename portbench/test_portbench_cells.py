"""The harness is driven by data: cells, configurations, drivers and
per-layer metrics are found by name, and a new cell is a new file."""

import json
import os
import shutil

import pytest

from portbench import cells, run as harness


def test_every_cell_of_the_benchmark_loads():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"], bench=bench)
        assert cell.config["name"] == w["config"]
        for kind in ("end_to_end", "per_layer"):
            assert cells.metrics_for(w["name"], bench, kind)
    names = [m["name"] for m in bench["end_to_end"]]
    assert "setup_s" in names
    for m in bench["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))
        assert m["moves"] in names


def test_every_workload_file_loads():
    names = sorted(f[:-5] for f in os.listdir(os.path.join(
        cells.HERE, "workloads")))
    assert names == sorted(w["name"] for w in
                           cells.benchmark()["workloads"])
    for name in names:
        assert cells.load_cell(name).name == name


def test_every_config_file_is_its_benchmark_entry():
    bench = cells.benchmark()
    for c in bench["configs"]:
        with open(os.path.join(cells.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        harness.svs_config(cfg)  # the program takes every field


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(cells.ROOT, "portbench"),
                    root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), root)
    return str(root)


def test_a_new_cell_is_found_from_its_file_alone(tmp_path):
    root = _copy(tmp_path)
    new = {"config": "fine_tune", "traffic": "train.b16.6x60s",
           "chips": 1, "why": "fine-tune training at batch 16",
           "driver": "train_loop",
           "params": {"batch": 16, "ref_steps": 3},
           "trace_seconds": 3,
           "limits": {"loss_gap": 0.5, "grad_gap_median": 0.5,
                      "replay_grad_gap_median": 0.5, "change_gap": 0.5}}
    path = os.path.join(root, "portbench", "workloads",
                        "train-ft-b16.json")
    with open(path, "w") as f:
        json.dump(new, f)
    cell = cells.load_cell("train-ft-b16", root=root)
    assert (cell.config_name, cell.driver, cell.params["batch"]) == (
        "fine_tune", "train_loop", 16)
    # listed in BENCHMARK.json, the two must agree
    bench = cells.benchmark(root)
    bench["workloads"].append(dict(name="train-ft-b16",
                                   config="fine_tune", traffic="other",
                                   chips=1, why=new["why"]))
    with pytest.raises(cells.CellError, match="traffic"):
        cells.load_cell("train-ft-b16", root=root, bench=bench)


@pytest.mark.parametrize("change, match", [
    (lambda w: w["params"].pop("burst"), "missing"),
    (lambda w: w["params"].update(rate=3), "unknown"),
    (lambda w: w["params"].update(burst="8"), "must be int"),
    (lambda w: w.update(config="default"), "from its configuration"),
    (lambda w: w.update(config="nowhere"), "no file"),
    (lambda w: w.update(driver="nowhere"), "no file"),
    (lambda w: w["limits"].pop("vocal_err"), "limits"),
    (lambda w: w.update(chips=2), "chips"),
])
def test_a_broken_cell_file_is_refused(tmp_path, change, match):
    root = _copy(tmp_path)
    path = os.path.join(root, "portbench", "workloads",
                        "decode-ft-stream.json")
    with open(path) as f:
        w = json.load(f)
    change(w)
    with open(path, "w") as f:
        json.dump(w, f)
    with pytest.raises(cells.CellError, match=match):
        cells.load_cell("decode-ft-stream", root=root)


def test_a_new_metric_is_found_from_its_file_alone(tmp_path):
    root = _copy(tmp_path)
    with open(os.path.join(root, "portbench", "metrics",
                           "steps.train.py"), "w") as f:
        f.write("def read(r):\n    return r['window'].get('attempted')\n")
    read = cells.metric_reader("steps.train", root=root)
    assert read({"window": {"attempted": 7}}) == 7
    with pytest.raises(cells.CellError):
        cells.metric_reader("absent.train", root=root)


def test_the_shares_of_the_peak_read_the_untraced_window():
    r = {"window": {"patches": 10, "train_flops_per_patch": 1e12,
                    "songs": 4, "decode_flops_per_song": 5e12,
                    "seconds": 2.0},
         "traced_window": {"patches": 99, "songs": 99, "seconds": 9.0},
         "trace": {"window_s": 9.0, "busy_s": 3.0}, "peak_flops": 1e15}
    for name in ("mfu_pct.train", "mfu_pct.train.fine_tune"):
        assert cells.metric_reader(name)(r) == pytest.approx(0.5)
    assert cells.metric_reader("mfu_pct.decode")(r) == pytest.approx(1.0)
    assert cells.metric_reader("mfu_pct.train")(
        dict(r, peak_flops=None)) is None


def test_metrics_for_a_cell_follow_their_workload_lists():
    bench = {"end_to_end": [
        {"name": "a", "workloads": ["x"]}, {"name": "setup_s"}],
        "per_layer": [
            {"name": "p", "moves": "a", "workloads": ["x", "y"]},
            {"name": "q", "moves": "a"},
            {"name": "r", "moves": "setup_s", "workloads": ["y"]}]}
    assert [m["name"] for m in cells.metrics_for("x", bench,
                                                 "end_to_end")] == [
        "a", "setup_s"]
    assert [m["name"] for m in cells.metrics_for("x", bench,
                                                 "per_layer")] == ["p", "q"]
    assert [m["name"] for m in cells.metrics_for("y", bench,
                                                 "per_layer")] == ["p", "r"]


def test_the_jax_check_compares_whole_top_level_names():
    mods = {"svs_torch": 1, "svs_torch.models": 1, "jaxtyping": 1,
            "flaxen.x": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "svs_tpu.models.unet": 1, "optax": 1})
    assert harness.forbidden_modules(mods) == ["jax", "optax", "svs_tpu"]


def test_a_run_without_a_card_prints_no_result(capsys):
    if harness.torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.main(["--workload", "train-default-b32", "--seed", "1",
                         "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""

"""The port's ZeRO-1 and FSDP layouts (``svs_torch.parallel.zero``: the
channel rule, ``shard_state``, ``make_zero1_train_step``,
``unshard_state``, ``fit`` and ``train_cli`` with ``--zero1`` /
``--fsdp``) on two gloo ranks on the CPU.

The module starts its ranks once (a ``launch.Ranks`` pool, one thread a
rank) and runs every case through them; what they run is in
``tests/torch_zero_workers.py`` and ``tests/torch_dp_workers.py``, which
import no JAX.  The narrow U-Net of ``tests/test_torch_dp.py`` at 128
frames, float32.  Bounds:

- the channel rule is svs_tpu's ``tp.leaf_spec`` read in torch's layouts,
  and each rank's slice of each leaf (after ``to_jax_layout``) is the
  shard svs_tpu's ``zero.shard_state`` gives that rank on the 2-device
  virtual mesh, exactly: the parameters and BN statistics under FSDP, the
  Adam moments under both layouts, ``deconv6`` included;
- the gradient the sharded step hands to Adam against svs_tpu's
  ``make_zero1_train_step`` (its ``_GRAB`` optimizer keeps the gradient)
  under ``fft`` and ``pallas_fused`` (the Pallas kernel in interpret
  mode): test_torch_dp.py's bounds, loss 1e-5 relative, gradient 1e-5
  relative L2, BN 1e-5 absolute;
- one real Adam step against svs_tpu's: tests/test_zero.py's envelope,
  params max |d| <= 2.1 lr, mean < 2e-4;
- against the port's own DP step: at world size 2 the ZeRO-1 and FSDP
  steps (dropout 0.5, three steps, with and without accumulation) are the
  DP step's bits, Adam's moments included; at world size 1 they are
  ``make_train_step``'s bits;
- a two-rank ``fit`` under ZeRO-1 or FSDP writes the DP fit's metrics,
  log and ``.ckpt`` bytes; checkpoints resume across DP, ZeRO-1, FSDP and
  one device (one device: test_torch_dp.py's fit bounds).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dp_workers as W
import torch_zero_workers as Z
from test_torch_dp import (FIT, NARROW, _GRAB, _batch, _lines, _one_thread,
                           _opts, _sd, _songs)
from svs_torch.cli import train_cli
from svs_torch.models import torch_import as t_import
from svs_torch.models.unet import UNet
from svs_torch.parallel import zero as tzero
from svs_torch.parallel.launch import Ranks
from svs_torch.train import checkpoint as ckpt_lib
from svs_torch.train import loop as tloop
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_torch.utils.config import get_config
from svs_tpu.ops.pallas import fused_loss as jfl
from svs_tpu.parallel import mesh as jmesh
from svs_tpu.parallel import tp as jtp
from svs_tpu.parallel import zero as jzero
from svs_tpu.train import checkpoint as jck
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig


@pytest.fixture(autouse=True)
def one_thread():
    with _one_thread():
        yield


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks(2, timeout=600)
    yield pool
    pool.close()


def _hwio_dim(name, shape, dim):
    """The axis of svs_tpu's layout that axis ``dim`` of a torch leaf
    becomes (``to_jax_layout``)."""
    idx = np.arange(shape[dim]).reshape(
        [-1 if i == dim else 1 for i in range(len(shape))])
    h = t_import.to_jax_layout(name, np.broadcast_to(idx, shape).copy())
    return [ax for ax in range(h.ndim)
            if h.shape[ax] > 1 and np.any(np.diff(h, axis=ax))][0]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_leaf_spec_is_svs_tpus_rule_in_torch_layouts(n):
    """Every leaf of the ``default`` preset: the port's dim is the axis
    svs_tpu's ``tp.leaf_spec`` shards on its HWIO / vector form."""
    model = UNet(get_config("default"))
    dims = tzero.tree_shardings(model, n)
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if t.ndim == 0:
            assert dims[name] is None, name
            continue
        spec = tuple(jtp.leaf_spec(
            t_import.to_jax_layout(name, np.zeros(shape)).shape, n, "m"))
        want = spec.index("m") if "m" in spec else None
        got = dims[name]
        assert (got if got is None else _hwio_dim(name, shape, got)) \
            == want, (name, shape, got, spec)
    if n == 2:  # the transposed convs: O is dim 1, deconv6's I is dim 0
        assert dims["deconv1.weight"] == 1 and dims["conv4.0.weight"] == 0
        assert dims["deconv6.weight"] == 0 and dims["deconv6.bias"] is None
    want = {"model": {k: None for k in dims},
            "opt": {k: dims[k] for k, _ in model.named_parameters()}}
    assert tzero.state_shardings(_Mesh(n), get_config("default")) == want


class _Mesh:
    def __init__(self, size):
        self.size = size


def _shard_of(arr, rank, n):
    """svs_tpu's shard of ``arr`` (a jax.Array on the 2-device mesh) that
    device ``rank`` of the mesh holds."""
    for s in arr.addressable_shards:
        if s.device == jax.devices()[rank]:
            return np.asarray(s.data)
    raise AssertionError("no shard on that device")


def _leaf(tree, name):
    top, side, level, field = t_import.jax_path(name)
    return tree[top][side][level][field]


@pytest.mark.parametrize("fsdp", [False, True])
def test_each_ranks_shard_is_svs_tpus(ranks, tmp_path, fsdp):
    """One svs_tpu state with random Adam moments, written as a ``.ckpt``:
    the ranks resume it and shard it; svs_tpu shards it on its 2-device
    mesh.  Each rank's slice of each leaf, in svs_tpu's layout, is the
    shard svs_tpu places on that rank's device."""
    jcfg = JConfig(**NARROW)
    state = jstep.create_train_state(jax.random.key(0), jcfg)
    rng = np.random.default_rng(5)
    # Adam's moments random, its count 1 (a count of 0 is a fresh Adam)
    state = state._replace(opt_state=jax.tree.map(
        lambda x: (jnp.asarray(rng.standard_normal(x.shape), x.dtype)
                   if x.ndim else jnp.ones_like(x)
                   if jnp.issubdtype(x.dtype, jnp.integer) else x),
        state.opt_state))
    path = str(tmp_path / "j.ckpt")
    jck.save(path, state, epoch=0)
    mesh = jmesh.make_mesh(2)
    sharded = jzero.shard_state(state, mesh, fsdp=fsdp)
    adam = sharded.opt_state.inner_state[0]
    trees = {"mu": {"params": adam.mu}, "nu": {"params": adam.nu},
             "sd": {"params": sharded.params, "bn_state": sharded.bn_state}}
    got = ranks.run(Z.shards, NARROW, path, fsdp)
    seen = 0
    for rank, held in enumerate(got):
        for kind in ("mu", "nu", "sd"):
            for name, v in held[kind].items():
                if t_import.jax_path(name) is None:
                    continue  # num_batches_tracked: svs_tpu has none
                want = _shard_of(_leaf(trees[kind], name), rank, 2)
                np.testing.assert_array_equal(
                    t_import.to_jax_layout(name, v), want,
                    err_msg=f"rank {rank} {kind} {name}")
                seen += 1
        assert held["dims"]["deconv6.weight"] == 0
        assert held["sd"]["deconv6.weight"].shape == (
            (4, 1, 5, 5) if fsdp else (8, 1, 5, 5))
        assert held["mu"]["deconv6.weight"].shape == (4, 1, 5, 5)
        assert held["mu"]["deconv1.weight"].shape == (16, 8, 5, 5)
        assert held["mu"]["deconv6.bias"].shape == (1,)
    model = UNet(TConfig(**NARROW))
    n_params = len(list(model.parameters()))
    n_running = len([n for n, _ in model.named_buffers() if "running" in n])
    assert seen == 2 * (3 * n_params + n_running)


@pytest.mark.parametrize("layout,impl,b", [
    ("zero1", "fft", 2), ("zero1", "pallas_fused", 3), ("fsdp", "fft", 3),
    ("fsdp", "pallas_fused", 2)])
def test_gradient_matches_svs_tpus(ranks, layout, impl, b):
    cfg = dict(NARROW, mr_mag_impl=impl)
    jcfg = JConfig(**cfg)
    mesh = jmesh.make_mesh(2)
    state = jstep.create_train_state(jax.random.key(0), jcfg, _GRAB)
    start = _sd(state.params, state.bn_state)
    batch = _batch(b, b)
    jfl._INTERPRET = True
    try:
        step = jzero.make_zero1_train_step(mesh, jcfg, _GRAB,
                                           fsdp=layout == "fsdp")
        jstate, jaux = step(jzero.shard_state(state, mesh,
                                              fsdp=layout == "fsdp"),
                            jmesh.shard_batch(mesh, batch),
                            jax.random.key(1))
        jaux = {k: float(v) for k, v in jaux.items()}
    finally:
        jfl._INTERPRET = False
    want = _sd(jstate.opt_state, jstate.bn_state)  # the gradient, by name
    (m0, g0, bn0), (m1, g1, bn1) = ranks.run(Z.grads, cfg, start, batch,
                                             layout)
    assert m0 == m1
    for k in ("l1", "mr", "total"):
        assert abs(m0[k] - jaux[k]) <= 1e-5 * abs(jaux[k]), k
    num = sum(float(((g0[k] - want[k]) ** 2).sum()) for k in g0)
    den = sum(float((want[k] ** 2).sum()) for k in g0)
    assert np.sqrt(num / den) <= 1e-5
    assert abs(m0["grad_norm"] - np.sqrt(den)) <= 1e-5 * np.sqrt(den)
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k])
    for k in bn0:
        np.testing.assert_allclose(bn0[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        np.testing.assert_array_equal(bn0[k], bn1[k])


@pytest.mark.parametrize("layout", ["zero1", "fsdp"])
def test_adam_step_is_within_svs_tpus_envelope(ranks, layout):
    """One real Adam step of B = 4 from the same weights, no dropout:
    tests/test_zero.py's envelope of the step it holds against the
    unsharded one."""
    jcfg = JConfig(**dict(NARROW, mr_mag_impl="fft"))
    state = jstep.create_train_state(jax.random.key(0), jcfg)
    start = _sd(state.params, state.bn_state)
    batch = _batch(7, 4)
    mesh = jmesh.make_mesh(2)
    fsdp = layout == "fsdp"
    jstate, _ = jzero.make_zero1_train_step(mesh, jcfg, fsdp=fsdp)(
        jzero.shard_state(state, mesh, fsdp=fsdp),
        jmesh.shard_batch(mesh, batch), jax.random.key(1))
    want = _sd(jstate.params, jstate.bn_state)
    got = ranks.run(Z.steps, dict(NARROW, mr_mag_impl="fft"), [batch],
                    layout, state_dict=start)[0]["final"]["sd"]
    d = [np.abs(got[k] - want[k]) for k in want
         if "running" not in k and "num_batches" not in k]
    lr = jcfg.learning_rate
    assert max(float(x.max()) for x in d) <= 2.1 * lr
    assert sum(float(x.sum()) for x in d) / sum(x.size for x in d) < 2e-4


@pytest.fixture(scope="module")
def dp_runs(ranks):
    """The DP steps that the sharded steps are held against, by
    accumulation."""
    cfg = dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5)
    batches = [_batch(10 + i, 4) for i in range(3)]
    cache = {}

    def get(accum):
        if accum not in cache:
            with _one_thread():
                cache[accum] = ranks.run(Z.steps, cfg, batches, "dp",
                                         accum_steps=accum)
        return cache[accum]
    return cfg, batches, get


def _held_bytes(n_whole, n_cut, fsdp):
    """A rank's state bytes at world 2: the parameters (cut under FSDP) and
    Adam's two moments (cut under both); ``n_whole`` / ``n_cut`` the
    parameters' elements the rule holds whole / cuts."""
    params = n_whole + (n_cut // 2 if fsdp else n_cut)
    return 4 * (params + 2 * (n_whole + n_cut // 2))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("layout", ["zero1", "fsdp"])
def test_steps_are_dps_bits_at_world_2(ranks, dp_runs, layout, accum):
    """Three steps with dropout 0.5 (with ``accum`` 2: one Adam update and
    an open cycle): every step's metrics and gathered state, the final
    moments, step count and accumulated gradient are the DP step's bits;
    the ranks hold a state of the predicted bytes."""
    cfg, batches, get = dp_runs
    want = get(accum)[0]
    r0, r1 = ranks.run(Z.steps, cfg, batches, layout, accum_steps=accum)
    assert r0["metrics"] == r1["metrics"] == want["metrics"]
    for got in (r0, r1):
        for i, sd in enumerate(want["sds"]):
            for k in sd:
                np.testing.assert_array_equal(got["sds"][i][k], sd[k],
                                              err_msg=f"step {i} {k}")
        for kind in ("mu", "nu", "acc"):
            if want["final"][kind] is None:
                assert got["final"][kind] is None
                continue
            for k, v in want["final"][kind].items():
                np.testing.assert_array_equal(got["final"][kind][k], v,
                                              err_msg=f"{kind} {k}")
        assert got["final"]["count"] == want["final"]["count"]
        assert got["final"]["step"] == want["final"]["step"] == 3
    model = UNet(TConfig(**cfg))
    dims = tzero.tree_shardings(model, 2)
    whole = sum(p.numel() for n, p in model.named_parameters()
                if dims[n] is None)
    cut = sum(p.numel() for n, p in model.named_parameters()
              if dims[n] is not None)
    assert whole == 1  # deconv6.bias
    buffers = sum(b.numel() * b.element_size() for b in model.buffers())
    running = sum(b.numel() * b.element_size()
                  for n, b in model.named_buffers() if "running" in n)
    # Adam's step counts: a float32 scalar a parameter
    counts = 4 * len(list(model.parameters()))
    acc = (0 if accum == 1 else
           4 * (whole + cut // 2))  # the open cycle's running mean
    cut_buffers = running // 2 if layout == "fsdp" else 0
    assert want["bytes"][1] == 12 * (whole + cut) + buffers + counts + (
        4 * (whole + cut) if accum > 1 else 0)
    assert r0["bytes"][1] == r1["bytes"][1] == (
        _held_bytes(whole, cut, layout == "fsdp") + buffers - cut_buffers
        + counts + acc)


def test_world_of_one_is_make_train_steps_bits(ranks):
    """Rank 0 in a group of its own: two ZeRO-1 and two FSDP steps with
    dropout are the single-device steps, bit for bit."""
    cfg = dict(NARROW, mr_mag_impl="pallas_fused", dropout_rate=0.5)
    out = ranks.run(Z.world_of_one, cfg, [_batch(20, 3), _batch(21, 3)])
    assert out[1] is None
    one_m, one = out[0]["single"]
    for layout in ("zero1", "fsdp"):
        m, got = out[0][layout]
        assert m == one_m, layout
        for kind in ("sd", "mu", "nu"):
            for k, v in one[kind].items():
                np.testing.assert_array_equal(got[kind][k], v,
                                              err_msg=f"{layout} {k}")


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    return _songs(str(tmp_path_factory.mktemp("zero_songs")))


def _ckpts(out):
    d = os.path.join(out, "CKPT")
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".ckpt")}


def _metrics(out):
    return [{k: v for k, v in json.loads(x).items() if k != "secs"}
            for x in _lines(out, "metrics_t.jsonl")]


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """The ``.ckpt`` every fit here starts from: a resumed Adam takes the
    file's float32 betas, so a fresh start would differ from a resumed
    run (as in tests/test_torch_scan.py)."""
    path = str(tmp_path_factory.mktemp("zero_init") / "init.ckpt")
    ckpt_lib.save(path, tstep.create_train_state(0, TConfig(**FIT),
                                                 device="cpu"))
    return path


def _fit_opts(songs, out, init, **kw):
    return _opts(songs, out, **dict(dict(load_path=init), **kw))


@pytest.fixture(scope="module")
def dp_fit(ranks, songs, init, tmp_path_factory):
    """The two-rank DP fit (two epochs, validation each, across the
    learning-rate drop, the ``.pth`` exported) and its first epoch alone."""
    runs = {}
    with _one_thread():
        for epochs in (1, 2):
            out = str(tmp_path_factory.mktemp(f"dp_fit{epochs}"))
            r = ranks.run(W.fit, _fit_opts(songs, out, init, epoch=epochs,
                                           export_pth=True), FIT)
            assert [x["code"] for x in r] == [0, 0]
            runs[epochs] = out
    return runs


@pytest.mark.parametrize("layout", ["zero1", "fsdp"])
def test_two_rank_fit_writes_the_dp_fits_files(ranks, songs, init, dp_fit,
                                               tmp_path, layout):
    out = str(tmp_path)
    r0, r1 = ranks.run(W.fit, _fit_opts(songs, out, init, export_pth=True,
                                        **{layout: True}), FIT)
    assert r0["code"] == r1["code"] == 0
    assert r0["steps"] == r1["steps"] == 4 and r1["written"] == []
    want = dp_fit[2]
    assert _metrics(out) == _metrics(want)
    assert _lines(out, "log_t.txt") == _lines(want, "log_t.txt")
    got, ref = _ckpts(out), _ckpts(want)
    assert sorted(got) == ["svs_best_t.ckpt", "svs_t.ckpt", "svs_t_400.ckpt"]
    for name in ref:
        assert got[name] == ref[name], name
    for name in ("svs_t.pth", "svs_best_t.pth"):
        a, _ = t_import.load_pth(os.path.join(out, "CKPT", name))
        b, _ = t_import.load_pth(os.path.join(want, "CKPT", name))
        for k in b:
            assert torch.equal(a[k], b[k]), (name, k)
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k])


def test_checkpoints_resume_across_layouts(ranks, songs, init, dp_fit,
                                          tmp_path):
    """A ZeRO-1 first epoch writes the DP first epoch's ``.ckpt``; it
    resumes into DP (the DP two-epoch run's bytes) and into one device
    (its losses within test_torch_dp.py's fit bounds); a DP checkpoint
    resumes into FSDP (the DP run's bytes again)."""
    z1 = str(tmp_path / "z1")
    assert [r["code"] for r in ranks.run(
        W.fit, _fit_opts(songs, z1, init, epoch=1, zero1=True), FIT)] \
        == [0, 0]
    assert _ckpts(z1)["svs_t.ckpt"] == _ckpts(dp_fit[1])["svs_t.ckpt"]
    final = _ckpts(dp_fit[2])["svs_t.ckpt"]
    for layout, src in (("dp", z1), ("fsdp", dp_fit[1])):
        out = str(tmp_path / layout)
        kw = {} if layout == "dp" else {layout: True}
        r = ranks.run(W.fit, _opts(songs, out, load_path=os.path.join(
            src, "CKPT", "svs_t.ckpt"), **kw), FIT)
        assert [x["code"] for x in r] == [0, 0]
        assert [x["steps"] for x in r] == [2, 2]
        assert _ckpts(out)["svs_t.ckpt"] == final, layout
    one = str(tmp_path / "one")
    tloop.fit(tloop.TrainOptions(**_opts(songs, one, load_path=os.path.join(
        z1, "CKPT", "svs_t.ckpt")), device="cpu"), TConfig(**FIT))
    got, want = _lines(one, "log_t.txt"), _lines(dp_fit[2], "log_t.txt")
    assert len(got) == 2 and len(want) == 4
    for a, b in zip(got, want[2:]):
        assert a.startswith("Val ") == b.startswith("Val ")
        np.testing.assert_allclose(float(a.split()[-1]), float(b.split()[-1]),
                                   rtol=1e-3 if a.startswith("Val ")
                                   else 1e-4)


@pytest.mark.parametrize("layout,stop,saved", [
    ("fsdp", (0, "svs_t.ckpt"), (1, 2)), ("zero1", (1, 1), (0, 1))])
def test_sigterm_and_resume(ranks, songs, init, dp_fit, tmp_path, layout,
                            stop, saved):
    """A SIGTERM on one rank stops both with 143 where the flag is agreed:
    at the end of the first epoch (FSDP: rank 0 takes it while writing
    the latest checkpoint) or after the first step (ZeRO-1: rank 1), and
    rank 0's checkpoint holds the gathered state there.  The FSDP run
    resumed from the epoch's end finishes as the uninterrupted run did."""
    out = str(tmp_path)
    opts = _fit_opts(songs, out, init, **{layout: True})
    r0, r1 = ranks.run(W.fit, opts, FIT, stop=stop)
    assert r0["code"] == r1["code"] == 143
    assert r0["steps"] == r1["steps"] == saved[1]
    from svs_torch.train import flax_msgpack as fm
    raw = fm.unpackb(_ckpts(out)["svs_t.ckpt"])
    assert (raw["epoch"], raw["step"]) == saved
    resumed = ranks.run(W.fit, dict(opts, load_path=os.path.join(
        out, "CKPT", "svs_t.ckpt")), FIT)
    assert [r["code"] for r in resumed] == [0, 0]
    if layout == "fsdp":
        assert _ckpts(out)["svs_t.ckpt"] == _ckpts(dp_fit[2])["svs_t.ckpt"]
        assert _lines(out, "log_t.txt") == _lines(dp_fit[2], "log_t.txt")


@pytest.mark.parametrize("layout", ["zero1", "fsdp"])
def test_train_cli_trains_on_two_ranks(ranks, songs, tmp_path, layout):
    """``train_cli --dp --zero1`` / ``--dp --fsdp`` at the default preset's
    full width, float32, one step of 2 and a validation pass; rank 0
    writes."""
    argv = ["--label", "c", "--train_folder", songs, "--valid_folder",
            songs, "--load_path", str(tmp_path / "none.ckpt"), "--epoch",
            "1", "--val_interval", "1", "--batch_size", "2",
            "--samples_per_song", "1", "--dtype", "float32", "--ckpt_dir",
            str(tmp_path / "CKPT"), "--log_dir", str(tmp_path / "LOG"),
            "--dp", f"--{layout}", "--device", "cpu"]
    assert ranks.run(W.cli, "train_cli", argv) == [0, 0]
    lines = _lines(str(tmp_path), "log_c.txt")
    assert len(lines) == 2 and lines[1].startswith("Val ")
    assert all(np.isfinite(float(x.split()[-1])) for x in lines)
    assert sorted(os.listdir(tmp_path / "CKPT")) == ["svs_best_c.ckpt",
                                                     "svs_c.ckpt"]


@pytest.mark.parametrize("argv,says", [
    (["--zero1"], "pass --dp with them"),
    (["--fsdp"], "pass --dp with them"),
    (["--dp", "--zero1", "--tp", "2"], "compose with --dp only"),
    (["--dp", "--fsdp", "--epoch_scan"], "not cp/tp/zero1/fsdp")])
def test_train_cli_refuses_what_svs_tpus_refuses(argv, says, capsys):
    with pytest.raises(SystemExit) as err:
        train_cli.main(["--label", "x", "--device", "cpu", *argv])
    assert err.value.code == 2
    assert says in capsys.readouterr().err

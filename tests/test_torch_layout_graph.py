"""The layouts' train and eval steps as cached programs
(``svs_torch/train/graphs.py`` under ``parallel/dp.py``, ``zero.py``,
``tp.py`` and ``halo.py``) on two gloo ranks on the CPU.

On a CUDA device over NCCL the DP, ZeRO-1, FSDP, TP and CP steps run as
the cached captured program of their key.  Here the ranks route their
steps through the same program objects (``torch_layout_graph_workers
.routed`` patches ``graphs.programmed``), whose capture and replay run the
body on the CPU, so the key, the binding, the warm-up step, the static
buffers, the copies in and out and the host's counts run on every rank.
One ``launch.Ranks(2)`` pool for the module; TP on the (1, 2) mesh.  The
narrow U-Net of ``tests/test_torch_dp.py`` at 128 frames, float32,
``mr_mag_impl='fft'`` (DP also ``pallas_fused``: svs_tpu's Pallas kernel
in interpret mode, the port's plain version); numpy-seeded batches.
Bounds:

- against svs_tpu's jitted step of each layout on the 2-device virtual
  mesh, from the same weights (``torch_import.state_dict_from_jax``), no
  dropout, the learning rate 0 on both sides so that every call starts
  from the same parameters: four calls (a full batch, a batch of 3 padded
  to 4 with a 0 ``weight``, and a tail of another shape twice; CP: 3, 3
  weighted with a 0, 2 and 2 patches; tests/test_torch_dp.py's draws,
  ``_calls``), after each the losses, ``grad_norm``, each call's gradient
  (from Adam's first moment) and the BN running statistics within the
  bounds of the layout's own file (``BOUNDS``, ``_check_gradient``: DP,
  ZeRO-1 and FSDP loss 1e-5 relative, gradient 1e-5 relative L2, BN 1e-5
  absolute; TP's and CP's files' bounds); svs_tpu's references computed
  once for the module;
- against the port's own eager bodies (``step.eager``): the same bits,
  metrics, parameters, BN, Adam's moments and count, on both ranks, with
  dropout on and a learning-rate change, and the eval programs the eager
  eval's bits;
- a 2-rank ``fit`` (DP, and FSDP, whose eval program gathers inside)
  through the programs: the eager 2-rank ``fit``'s log, metrics and final
  state, bit for bit.
"""

import concurrent.futures
import json
import os

import numpy as np
import pytest
import torch

import jax

import torch_layout_graph_workers as L
from test_torch_dp import _batch as _dp_batch
from test_torch_dp import _lines, _one_thread, _opts, _sd, _songs
from svs_torch.parallel import mesh as tmesh
from svs_torch.parallel.launch import Ranks
from svs_torch.train import graphs
from svs_torch.train import scan as tscan
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig as TConfig
from svs_tpu.ops.pallas import fused_loss as jfl
from svs_tpu.parallel import dp as jdp
from svs_tpu.parallel import halo as jhalo
from svs_tpu.parallel import mesh as jmesh
from svs_tpu.parallel import multihost as jmultihost
from svs_tpu.parallel import tp as jtp
from svs_tpu.parallel import zero as jzero
from svs_tpu.train import step as jstep
from svs_tpu.utils.config import SVSConfig as JConfig

NARROW = dict(enc_channels=(4, 8, 8, 16, 16, 16), dropout_rate=0.0,
              input_len=128)
TP_SHAPE = (1, 2)
# the layouts held against svs_tpu: (layout, mr_mag_impl)
CASES = (("dp", "fft"), ("dp", "pallas_fused"), ("zero1", "fft"),
         ("fsdp", "fft"), ("tp", "fft"), ("cp", "fft"))
LAYOUTS = ("dp", "zero1", "fsdp", "tp", "cp")
LR2 = 5e-4  # the learning rate after the change


@pytest.fixture(autouse=True)
def one_thread():
    with _one_thread():
        yield


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks(2, timeout=600)
    yield pool
    pool.close()


def _calls(kind, impl="fft"):
    """The global host batches of the calls against svs_tpu and the rows
    each is padded to (None: ``shard_batch``'s cut), as ``fit`` hands them
    to the step: a full batch, a batch of 3 padded to 4 with a 0
    ``weight``, then a tail of another shape twice.  CP cuts time, not
    rows: its padded batch carries the 0 ``weight``.  ``pallas_fused``
    takes the first two.  They are tests/test_torch_dp.py's draws
    (``_batch(b, b)``), on which its gradient bound was set: on other
    draws the eager steps of the two packages, the single-device ones
    included, part by up to 7e-4 relative L2 of the gradient (ROADMAP
    C.8), so the draws hold the programs to the bound where the eager
    bodies meet it."""
    if kind == "cp":
        calls = [(_dp_batch(3, 3), None),
                 (dict(_dp_batch(3, 3), weight=np.asarray([1, 1, 0],
                                                          np.float32)),
                  None),
                 (_dp_batch(2, 2), None), (_dp_batch(2, 2), None)]
    else:
        calls = [(_dp_batch(4, 4), None), (_dp_batch(3, 3), 4),
                 (_dp_batch(2, 2), None), (_dp_batch(2, 2), None)]
    return calls[:2] if impl == "pallas_fused" else calls


def _jax_input(kind, mesh, batch, pad):
    """svs_tpu's input of the call, cut as the port's ``layout_batch``
    cuts it."""
    if kind == "cp":
        return jhalo.shard_batch_time(mesh, batch)
    if pad is None and kind != "tp":
        return jmesh.shard_batch(mesh, batch)
    return jmultihost.global_batch_from_global(mesh, batch, pad_rows_to=pad)


def _jax_run(kind, impl):
    """svs_tpu's jitted step of ``kind`` over the calls from its state of
    key 0 at learning rate 0: the start state dict, and after each call
    the metrics, the BN running statistics and Adam's first moment by the
    port's names."""
    jcfg = JConfig(**NARROW, mr_mag_impl=impl, learning_rate=0.0)
    opt = jstep.make_optimizer(jcfg)
    state = jstep.create_train_state(jax.random.key(0), jcfg, opt)
    start = _sd(state.params, state.bn_state)  # the step donates the state
    if kind == "tp":
        mesh = jtp.make_2d_mesh(*TP_SHAPE)
        step, state = (jtp.make_tp_train_step(mesh, jcfg, opt),
                       jtp.shard_state(state, mesh))
    else:
        mesh = jmesh.make_mesh(2)
        if kind in ("zero1", "fsdp"):
            fsdp = kind == "fsdp"
            step, state = (jzero.make_zero1_train_step(mesh, jcfg, opt,
                                                       fsdp=fsdp),
                           jzero.shard_state(state, mesh, fsdp=fsdp))
        else:
            make = (jhalo.make_cp_train_step if kind == "cp"
                    else jdp.make_dp_train_step)
            step, state = (make(mesh, jcfg, opt),
                           jdp.replicate_state(state, mesh))
    out = []
    jfl._INTERPRET = impl == "pallas_fused"
    try:
        for batch, pad in _calls(kind, impl):
            state, aux = step(state, _jax_input(kind, mesh, batch, pad),
                              jax.random.key(1))
            sd = _sd(state.params, state.bn_state)
            mu = _sd(state.opt_state.inner_state[0].mu, state.bn_state)
            out.append({"metrics": {k: float(v) for k, v in aux.items()},
                        "bn": {k: v for k, v in sd.items()
                               if "running" in k},
                        "mu": {k: mu[k] for k in start
                               if "running" not in k
                               and "num_batches" not in k}})
    finally:
        jfl._INTERPRET = False
    return start, out


@pytest.fixture(scope="module", autouse=True)
def _refs_job():
    """svs_tpu's references of every case, once for the module, computed
    on a thread of this process while the ranks run the cases before the
    ones that read them (the file's svs_tpu cases come last)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(lambda: {case: _jax_run(*case) for case in CASES})
        yield job
        job.cancel()


@pytest.fixture(scope="module")
def svs_tpu_refs(_refs_job):
    return _refs_job.result()


def _evals(kind):
    """Validation batches as ``fit`` hands them to the eval step: a full
    batch, a remainder padded to its rows, and (CP, on the whole batch) a
    batch of another shape."""
    if kind == "cp":
        return [(_dp_batch(16, 3), 3), (_dp_batch(17, 2), 2)]
    return [(_dp_batch(16, 4), 4), (_dp_batch(17, 3), 4)]


@pytest.mark.parametrize("kind", LAYOUTS)
def test_programs_are_the_eager_bodys_bits(ranks, kind):
    """Four calls (a full batch, the padded batch, the tail twice; dropout
    0.5, Adam at its learning rate) leave each rank the eager body's
    state, with its metrics, and the eval programs give the eager eval's
    bits (the learning-rate change is ``test_program_keys_...``'s)."""
    cfg = dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5)
    calls = _calls(kind)
    out = ranks.run(L.against_eager, kind, TP_SHAPE, cfg, calls,
                    _evals(kind))
    for rank in out:
        prog, eager = rank["program"], rank["eager"]
        for a, b in zip(prog["metrics"] + prog["evals"],
                        eager["metrics"] + eager["evals"]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for part in ("sd", "mu", "nu"):
            for k, v in eager[part].items():
                np.testing.assert_array_equal(prog[part][k], v,
                                              err_msg=f"{part} {k}")
        assert prog["count"] == eager["count"] == len(calls)
        assert prog["step"] == eager["step"] == len(calls)
        # the full batch's program (the padded batch its replay) and the
        # tail's, each a warm-up step and a capture; the eager body built
        # none
        assert sorted(prog["programs"]) == [(1, 1), (1, 1)]
        assert eager["programs"] == [] and eager["builds"] == 0
        # two train programs and the eval programs of the signatures
        assert prog["builds"] == 2 + (2 if kind == "cp" else 1)
    for part in ("sd", "mu", "nu"):  # both ranks the same bits
        for k, v in out[0]["program"][part].items():
            np.testing.assert_array_equal(out[1]["program"][part][k], v)


def test_program_keys_rebinding_and_returned_metrics(ranks, tmp_path):
    cfg = dict(NARROW, mr_mag_impl="fft")
    got = ranks.run(L.rules, cfg, _dp_batch(18, 4), str(tmp_path))
    for r in got:
        assert r["first"] == (1, 2)  # a warm-up step, a capture, replays
        assert r["lr"] == 2 and r["restore"] == 3  # each captures again
        # the DP program, the single step's and the DP one over another
        # mesh: three keys, one of them without a mesh
        assert r["builds"] == 3 and r["distinct_meshes"] == 3
        assert r["keys"] == [("train", "dp", False), ("train", "dp", False),
                             ("train", "single", True)]
        assert not r["aliases"] and r["kept"]


def test_the_rule_takes_nccl_and_a_world_of_one_and_leaves_gloo_eager(
        monkeypatch):
    """``graphs.mesh_programmed`` decides before any step, from the mesh
    alone: a CUDA mesh over NCCL and a world of one take programs, gloo
    across ranks on a CUDA device (the ranks that share one card) stays
    eager, and ``epoch_scan`` refuses it by the same test.  The meshes
    here run no collective."""
    cuda = torch.device("cuda", 0)

    def mesh(size, backend, dev=cuda):
        return tmesh.Mesh(None, 0, size, dev, backend=backend)

    assert graphs.mesh_programmed(mesh(2, "nccl"))
    assert graphs.mesh_programmed(mesh(1, "gloo"))
    assert graphs.mesh_programmed(mesh(1, "nccl"))
    assert not graphs.mesh_programmed(mesh(2, "gloo"))
    assert tmesh.host_collectives(mesh(4, "gloo"))
    assert not tmesh.host_collectives(mesh(2, "nccl"))
    # the CPU stays eager unless a caller routes it (the tests do)
    assert not graphs.mesh_programmed(mesh(2, "gloo", torch.device("cpu")))
    with pytest.raises(ValueError, match="gloo"):
        tscan.refuse_mesh(mesh(2, "gloo"))
    # a step over the gloo ranks runs its body eagerly and builds no
    # program; over NCCL it goes through its program (here on the CPU,
    # where a program runs the body)
    cache = graphs.infer_graphs.ProgramCache(graphs.MAX_BYTES)
    monkeypatch.setattr(graphs, "CACHE", cache)
    cfg = TConfig(**NARROW, mr_mag_impl="fft")
    state = tstep.create_train_state(0, cfg, device="cpu")
    ran = []

    def body(state, batch, generator=None):
        ran.append(len(cache))
        return {"total": batch["mix"].sum()}

    for m, built in ((mesh(2, "gloo"), 0), (mesh(2, "nccl"), 1)):
        state, got = graphs.train_step(cfg, body, "dp", m)(
            state, {"mix": torch.ones(2, 3)})
        assert float(got["total"]) == 6.0 and len(cache) == built
    assert ran == [0, 1] and state.step == 2


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    return _songs(str(tmp_path_factory.mktemp("layout_graph_songs")))


@pytest.mark.parametrize("layout", [{}, {"fsdp": True}])
def test_programmed_fit_is_the_eager_fit(ranks, songs, tmp_path, layout):
    """Two epochs of a 2-rank ``fit`` (a ragged tail an epoch, validation
    each epoch, dropout on, the learning rate dropped at the second) with
    the steps as programs and as their eager bodies: the same text log,
    metrics (but the epochs' seconds) and final state, bit for bit."""
    cfg = dict(NARROW, mr_mag_impl="fft", dropout_rate=0.5,
               samples_per_song=3, lr_drop_epoch=1, lr_after_drop=LR2)
    runs = {}
    for on in (True, False):
        out = str(tmp_path / f"on{on}")
        runs[on] = (out, ranks.run(L.fit, dict(_opts(songs, out,
                                                      batch_size=4),
                                               **layout), cfg, on))
    (p_out, prog), (e_out, eager) = runs[True], runs[False]
    assert _lines(p_out, "log_t.txt") == _lines(e_out, "log_t.txt")

    def metrics(out):
        return [{k: v for k, v in json.loads(x).items() if k != "secs"}
                for x in _lines(out, "metrics_t.jsonl")]

    assert metrics(p_out) == metrics(e_out)
    for a, b in zip(prog, eager):
        assert a["step"] == b["step"] == 4  # 6 patches: 4 and 2 an epoch
        for part in ("sd", "mu", "nu"):
            for k, v in b[part].items():
                np.testing.assert_array_equal(a[part][k], v, err_msg=k)
        # the full batch's and the tail's train programs, and validation's
        assert a["builds"] == 3 and b["builds"] == 0
    assert os.path.exists(os.path.join(p_out, "CKPT", "svs_t.ckpt"))


def _grads(calls):
    """Each call's gradient from Adam's first moment at learning rate 0
    (``mu_i = b1 mu_(i-1) + (1 - b1) g_i``), by name."""
    b1 = tstep.BETAS[0]
    out, prev = [], None
    for c in calls:
        mu = c["mu"]
        out.append({k: (v - (0 if prev is None else b1 * prev[k]))
                    / (1 - b1) for k, v in mu.items()})
        prev = mu
    return out


def _check_gradient(kind, got, want, start):
    """The gradient bound of the layout's own test file: DP, ZeRO-1 and
    FSDP (tests/test_torch_dp.py, test_torch_zero.py) 1e-5 relative L2;
    TP (test_torch_tp.py) the parameters after an SGD step of lr 0.01 at
    atol 1e-4 / rtol 1e-3; CP (test_torch_cp.py) the parameters after
    Adam's first update at lr 1e-3 within its envelope (max |d| <= 2.1e-3,
    mean < 2e-4)."""
    if kind == "tp":
        for k, v in want.items():
            np.testing.assert_allclose(start[k] - 0.01 * got[k],
                                       start[k] - 0.01 * v, atol=1e-4,
                                       rtol=1e-3, err_msg=k)
    elif kind == "cp":
        eps = tstep.EPS
        d = np.concatenate([
            np.abs(1e-3 * (got[k] / (np.abs(got[k]) + eps)
                           - v / (np.abs(v) + eps))).ravel()
            for k, v in want.items()])
        assert d.max() <= 2.1e-3 and d.mean() < 2e-4
    else:
        num = sum(float(((got[k] - v) ** 2).sum()) for k, v in want.items())
        den = sum(float((v ** 2).sum()) for v in want.values())
        assert np.sqrt(num / den) <= 1e-5


# each layout file's bounds on the metrics and the BN running statistics
# (relative on a loss and grad_norm; atol, rtol on BN): the DP and ZeRO
# files' loss 1e-5 and BN 1e-5, the gradient's 1e-5 bounding its norm;
# test_torch_tp.py's loss 1e-5, grad_norm 1e-3 and BN 1e-5 / 1e-4;
# test_torch_cp.py's total 1e-6, grad_norm 1e-4 and BN 1e-5
BOUNDS = {"dp": (1e-5, 1e-5, 1e-5, (1e-5, 0)),
          "tp": (1e-5, 1e-5, 1e-3, (1e-5, 1e-4)),
          "cp": (1e-5, 1e-6, 1e-4, (1e-5, 0))}


@pytest.mark.parametrize("kind,impl", CASES)
def test_programs_match_svs_tpus_jitted_layout_steps(ranks, svs_tpu_refs,
                                                     kind, impl):
    start, want = svs_tpu_refs[(kind, impl)]
    cfg = dict(NARROW, mr_mag_impl=impl, learning_rate=0.0)
    out = ranks.run(L.against_svs_tpu, kind, TP_SHAPE, cfg, start,
                    _calls(kind, impl))
    (got, progs), (got1, progs1) = out
    assert len(got) == len(want)
    loss, total, grad_norm, (atol, rtol) = BOUNDS.get(kind, BOUNDS["dp"])
    for i, (g, w, dg, dw) in enumerate(zip(got, want, _grads(got),
                                           _grads(want))):
        assert g["metrics"] == got1[i]["metrics"], i  # every rank's
        for k, bound in (("l1", loss), ("mr", loss), ("total", total),
                         ("grad_norm", grad_norm)):
            assert abs(g["metrics"][k] - w["metrics"][k]) \
                <= bound * abs(w["metrics"][k]), (i, k)
        _check_gradient(kind, dg, dw, start)
        for k, v in w["bn"].items():
            np.testing.assert_allclose(g["bn"][k], v, rtol=rtol, atol=atol,
                                       err_msg=f"call {i} {k}")
    # the full batch's program (its first call the warm-up step, the
    # padded batch of its shape the capture and a replay); the tail's
    # (a warm-up step, then a capture and a replay)
    assert sorted(progs) == sorted(progs1) == (
        [(1, 1)] if impl == "pallas_fused" else [(1, 1), (1, 1)])

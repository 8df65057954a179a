"""The port's multi-device dry run, ``bench_cli --dp-smoke`` (after
``__graft_entry__.dryrun_multichip`` and svs_tpu's ``bench_cli._dp_smoke``).

:func:`dp_smoke` starts ``devices`` gloo ranks on the CPU (a
:class:`~svs_torch.parallel.launch.Ranks` pool) and runs
:func:`dp_smoke_rank` on each, at the dry run's shapes (``input_len`` 64,
dropout 0.5, one patch a rank):

- one DP train step of a global batch, held on rank 0 against the
  unsharded step of the same batch, state and dropout generator under
  svs_tpu's envelope (:data:`ENVELOPE`), and every rank's state against
  rank 0's, bit for bit;
- where ``n > 1`` and ``128 % n == 0`` (``dryrun_multichip``'s guard), the
  same step under ZeRO-1 and under FSDP (:mod:`~svs_torch.parallel.zero`):
  the layout must shard (each leaf a rank holds is the channel rule's
  slice), the step stay within the envelope of the unsharded step, and
  the gathered state be the same bits on every rank
  (:func:`layout_parity`);
- where ``n >= 4`` and ``n`` is even (``dryrun_multichip``'s guard), the
  same step under TP (:mod:`~svs_torch.parallel.tp`) on a ``(2, n / 2)``
  mesh: ``conv4.0.weight`` must be cut to ``128 / (n / 2)`` output
  channels, the step stay within the envelope of the unsharded step and
  the gathered state be the same bits on every rank;
- the segment-parallel decode (``separate_magnitude_mesh``, both modes)
  against ``separate_magnitude`` on rank 0;
- context parallelism (:mod:`~svs_torch.parallel.halo`): one CP train step
  of a batch of 2 patches of ``64 * n`` frames, its time axis cut over the
  ``n`` ranks, held on rank 0 against the unsharded step of the same
  batch, state and dropout generator under :data:`ENVELOPE`, every rank's
  state rank 0's bits (:func:`cp_parity`); and the whole-song CP decode
  (``separate_magnitude_mesh(mode="whole")``) of a song of ``lcm(64 * n,
  8 * input_len)`` frames against the unsharded ``mode="whole"`` decode
  within :data:`CP_ATOL` (:func:`cp_decode_parity`).  The two decodes pad
  a song alike only at such a length (to ``64 * n`` and to ``8 *
  input_len`` frames): ``64 * n`` itself, ``dryrun_multichip``'s, at
  ``n = 8``.

- multi-host (:mod:`~svs_torch.parallel.multihost`), where ``n`` is even:
  the pool's ranks as 2 hosts of ``n / 2``, each host's local batch its
  ``ceil((n + 1) / 2)``-row share of a global batch of ``n + 1`` patches,
  each rank's block of it from ``global_batch_from_local`` (the last host's
  batch padded with zero rows and weight); one DP step on those blocks held
  on rank 0 against the unsharded step of the host-major padded global
  batch with its ``weight``, under :data:`ENVELOPE`, every rank's state
  rank 0's bits (:func:`mh_parity`; svs_tpu's
  ``test_two_process_step_matches_single_device``).

Then, where ``n >= 2`` (``dryrun_multichip``'s guard), in the calling
process and not in the pool: the ``n_micro = 1`` PP step
(:mod:`~svs_torch.parallel.pp`) on two stage devices (``("cpu", "cpu")``)
against the unsharded step of the same batch, state and generator, under
the same envelope (:func:`pp_parity`).

Each layout's step is the one ``fit`` runs: the cached program of its key
where ``graphs.mesh_programmed`` (a CUDA device over NCCL, or a world of
one), and then held against its eager body bit for bit and timed beside
it (:func:`layout_parity`'s timing runs, :func:`program_parity` on a
caller's batches); gloo ranks (the CPU's, or ranks sharing one card) run
the eager bodies, and ``detail`` says so.  So do PP's step where both
stages are one CUDA device (``pp.programmed``; :func:`pp_program_parity`),
the SP mask on any CUDA rank (:func:`sp_program_parity`) and the
whole-song CP decode where ``separate._routed`` says so over the mesh
(:func:`cp_decode_parity`'s ``vs_eager``).

It returns svs_tpu's JSON line (``metric``, ``ok``, ``devices``,
``wall_s``, ``detail``); ``detail`` names the layouts checked and those not
ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from svs_torch.losses.mrstft import combined_loss
from svs_torch.parallel import dp
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.parallel import halo, multihost, pp, tp, zero
from svs_torch.train import graphs
from svs_torch.train import step as tstep
from svs_torch.utils.config import SVSConfig

# __graft_entry__.dryrun_multichip's bounds for one DP step against the
# unsharded step: loss relative, grad norm relative to max(norm, 1), BN
# running statistics absolute, parameters max |d| in learning rates (Adam's
# first update is ~lr * sign(grad), whose sign a reordered sum may flip
# where the gradient is ~0) and mean |d|
ENVELOPE = {"loss": 1e-5, "grad_norm": 1e-3, "bn": 1e-4, "params_max_lr": 2.1,
            "params_mean": 2e-4}
# the layouts this dry run checks, and svs_tpu's that it does not yet
CHECKED = ("dp", "sp", "zero1", "fsdp", "tp", "pp", "cp", "multihost")
NOT_PORTED = ()
# the training layouts of one data mesh
LAYOUTS = ("dp", "zero1", "fsdp")
# the SP decode's atol against the unsharded one (tests/test_infer_mesh.py)
SP_ATOL = 2e-5
# the whole-song CP decode's atol against the unsharded whole decode
# (tests/test_infer_mesh.py, __graft_entry__.dryrun_multichip)
CP_ATOL = 3e-5
# the epoch seed of the multi-host data and remix checks
MH_SEED = 11


def dry_batch(b: int, frames: int = 64) -> Dict[str, np.ndarray]:
    """The dry run's random global batch of 64-frame patches
    (``dryrun_multichip``'s draws), or of ``frames``."""
    rng = np.random.default_rng(0)
    shape = (b, 512, frames)
    return {
        "mix": rng.random(shape, np.float32),
        "voc": rng.random(shape, np.float32) * 0.5,
        "mix_angle": (rng.random(shape, np.float32) - 0.5) * 6,
        "voc_angle": (rng.random(shape, np.float32) - 0.5) * 6,
    }


def _host_max(value: float, mesh: mesh_lib.Mesh) -> float:
    """The largest of the ranks' ``value``s."""
    if not mesh_lib.crosses(mesh):
        return value
    t = torch.tensor([value], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX,
                    group=mesh.host_group or mesh.group)
    return float(t)


def _state_dict(state) -> Dict[str, torch.Tensor]:
    """A state's full state dict (a :class:`TrainState`'s, or given)."""
    return (state.model.state_dict() if isinstance(state, tstep.TrainState)
            else state)


def envelope(got: Dict[str, torch.Tensor], got_state,
             want: Dict[str, torch.Tensor], want_state,
             lr: float) -> Dict[str, object]:
    """One step's metrics and state (a :class:`TrainState` or a full state
    dict) against another's, under :data:`ENVELOPE`: the deltas and
    ``ok``."""
    total, ref_total = float(got["total"]), float(want["total"])
    gn, ref_gn = float(got["grad_norm"]), float(want["grad_norm"])
    b = _state_dict(want_state)
    a = {k: v.to(b[k].device) for k, v in _state_dict(got_state).items()}
    bn = max(float((a[k].float() - b[k].float()).abs().max()) for k in a
             if "running" in k)
    params = [(a[k] - b[k]).abs() for k in a
              if "running" not in k and "num_batches" not in k]
    out = {
        "loss_rel": abs(total - ref_total) / max(abs(total), 1.0),
        "grad_norm_rel": abs(gn - ref_gn) / max(ref_gn, 1.0),
        "bn_abs": bn,
        "params_max": max(float(d.max()) for d in params),
        "params_mean": (sum(float(d.sum()) for d in params)
                        / sum(d.numel() for d in params)),
        "total": total, "ref_total": ref_total,
    }
    out["ok"] = bool(out["loss_rel"] <= ENVELOPE["loss"]
                     and out["grad_norm_rel"] <= ENVELOPE["grad_norm"]
                     and out["bn_abs"] < ENVELOPE["bn"]
                     and out["params_max"] <= ENVELOPE["params_max_lr"] * lr
                     and out["params_mean"] < ENVELOPE["params_mean"])
    return out


def _loss_kernel_counts():
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    return (cdm.fwd_launches, cdm.bwd_launches, cfl.fwd_launches,
            cfl.bwd_launches)


def no_tf32(mesh: mesh_lib.Mesh) -> None:
    """Keep cuDNN's convs and cuBLAS's matmuls from rounding f32 operands to
    TF32 in this rank's process (a parity check on the card)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def deterministic(mesh: mesh_lib.Mesh) -> None:
    """cuDNN's deterministic algorithms in this rank's process: two steps
    held against each other bit for bit on the card."""
    torch.backends.cudnn.deterministic = True


def collective_probe(mesh: mesh_lib.Mesh) -> float:
    """One all-reduce of a 1 from every rank on the mesh's device: the
    rank count where the backend runs it."""
    t = torch.ones(1, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return float(t)


def _event_ms(fn, dev, reps: int, warmup: int = 0) -> float:
    """The mean of ``reps`` calls of ``fn()`` by CUDA events, after
    ``warmup`` calls (a program's eager first call and its capture)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def layout_state(kind: str, cfg: SVSConfig, mesh: mesh_lib.Mesh,
                 seed: int = 0, state: Optional[tstep.TrainState] = None,
                 n_micro: int = 1):
    """The state of ``seed`` (or ``state``, rank 0's) on every rank in
    layout ``kind`` (``dp``, ``zero1``, ``fsdp``, ``cp``, ``tp`` on a
    ``Mesh2D``, or ``pp`` on a pair of stage devices: PP at ``n_micro``
    microbatches, at ``pp``'s split) and its train step (a program where
    ``graphs.mesh_programmed``, or ``pp.programmed``; ``step.eager`` its
    eager body)."""
    if kind == "pp":
        state = state or tstep.create_train_state(
            seed, cfg, device=pp.stage_devices(mesh)[0])
        return (pp.shard_state(state, mesh),
                pp.make_pp_train_step(mesh, cfg, n_micro=n_micro))
    state = dp.replicate_state(
        state or tstep.create_train_state(seed, cfg, device=mesh.device),
        mesh)
    if kind == "dp":
        return state, dp.make_dp_train_step(mesh, cfg)
    if kind == "cp":
        return state, halo.make_cp_train_step(mesh, cfg)
    if kind == "tp":
        return tp.shard_state(state, mesh), tp.make_tp_train_step(mesh, cfg)
    fsdp = kind == "fsdp"
    return (zero.shard_state(state, mesh, fsdp=fsdp),
            zero.make_zero1_train_step(mesh, cfg, fsdp=fsdp))


def layout_eval_step(kind: str, cfg: SVSConfig, mesh: mesh_lib.Mesh):
    """The validation step ``fit`` runs under layout ``kind`` (CP's is the
    plain eval step on the whole batch)."""
    if kind == "tp":
        return tp.make_tp_eval_step(mesh, cfg)
    if kind == "cp":
        return tstep.make_eval_step(cfg)
    if kind == "pp":
        return pp.make_pp_eval_step(mesh, cfg)
    return zero.make_zero1_eval_step(mesh, cfg, fsdp=kind == "fsdp")


def layout_batch(kind: str, mesh: mesh_lib.Mesh, batch,
                 pad_rows_to: Optional[int] = None) -> Dict[str,
                                                            torch.Tensor]:
    """This rank's train step input of the global host ``batch`` under
    ``kind``, as ``fit`` cuts it: its rows (``mesh.shard_batch``, over the
    data sub-mesh under TP; with ``pad_rows_to`` padded to that many rows
    with zero ``weight``, ``global_batch_from_global``) or under CP its
    time block (``halo.shard_batch_time``); under PP the whole batch,
    padded to ``pad_rows_to`` rows (``pp.pad_batch``) where given."""
    if kind == "cp":
        return halo.shard_batch_time(mesh, batch)
    if kind == "pp":
        return pp.pad_batch(batch, pad_rows_to or len(batch["mix"]))
    rows = mesh.data if kind == "tp" else mesh
    if pad_rows_to is None:
        return mesh_lib.shard_batch(rows, batch)
    return mesh_lib.global_batch_from_global(rows, batch, pad_rows_to)


def layout_val_batch(kind: str, mesh: mesh_lib.Mesh, batch,
                     rows: int) -> Dict[str, torch.Tensor]:
    """The eval step's input of the host validation ``batch`` as ``fit``
    makes it: padded to ``rows`` and cut, under CP whole, under PP padded
    to ``rows`` on the host."""
    if kind == "cp":
        return tstep.batch_to_device(batch, mesh.device)
    if kind == "pp":
        return pp.pad_batch(batch, rows)
    return mesh_lib.global_batch_from_global(
        mesh.data if kind == "tp" else mesh, batch, rows)


def _full(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """The full state on the host (gathered: a collective): the state
    dict and Adam's moments."""
    snap = zero.unshard_state(state)
    return {"sd": snap.state_dict, "mu": snap.exp_avg, "nu": snap.exp_avg_sq}


def programs(model) -> List[Tuple[int, int]]:
    """(captures, replays) of the cached train programs of ``model``."""
    return [(p.captures, p.replays) for p in graphs.CACHE.programs_of(model)
            if hasattr(p, "captures")]


def program_parity(kind: str, cfg: SVSConfig, mesh: mesh_lib.Mesh,
                   batches: List[Dict[str, torch.Tensor]], seed: int = 0
                   ) -> Dict[str, object]:
    """Layout ``kind``'s train step (the program of its key where
    ``graphs.mesh_programmed``) against its eager body (``step.eager``),
    each from the state of ``seed`` with its own dropout generator of one
    seed, over this rank's step inputs ``batches``: ``vs_eager``, the
    largest |difference| of any call's metrics and of the full state after
    the last (parameters, BN, Adam's moments; 0.0: the same bits; a
    collective), ``programmed`` and ``programs`` (:func:`programs`: none
    where the step ran eagerly)."""
    dev = mesh.device
    got = []
    for form in ("program", "eager"):
        state, step = layout_state(kind, cfg, mesh, seed)
        run = step if form == "program" else step.eager
        gen = torch.Generator(dev).manual_seed(seed + 1)
        metrics = [{k: v.cpu() for k, v in run(state, b, gen)[1].items()}
                   for b in batches]
        got.append((metrics, _full(state),
                    programs(state.model) if form == "program" else None))
    (pm, pfull, progs), (em, efull, _) = got
    diff = max([_max_diff(a, b) for a, b in zip(pm, em)]
               + [_max_diff(pfull[k], efull[k]) for k in ("sd", "mu", "nu")])
    return {"vs_eager": diff, "programmed": graphs.mesh_programmed(mesh),
            "programs": progs, "calls": len(batches)}


def _max_diff(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
              ) -> float:
    """The largest |difference| between two dicts of tensors (0.0: the
    same values)."""
    if sorted(a) != sorted(b):
        return float("inf")
    return max([float((a[k].double() - b[k].double()).abs().max())
                for k in a if a[k].numel()] or [0.0])


def _spread(sd: Dict[str, torch.Tensor], mesh: mesh_lib.Mesh) -> float:
    """The largest |difference| between any rank's host state dict and
    rank 0's."""
    flat = torch.cat([v.reshape(-1).double() for v in sd.values()])
    ref = flat.clone()
    if mesh_lib.crosses(mesh):
        dist.broadcast(ref, src=mesh.src, group=mesh.host_group or mesh.group)
    return _host_max(float((flat - ref).abs().max()), mesh)


def _shards_ok(state, snap) -> bool:
    """Whether each parameter's moments (and under FSDP and TP the
    parameter and the running statistics) this rank holds are the channel
    rule's slice of the full leaf, and at least one leaf is cut where the
    state's mesh has more than one rank."""
    if not isinstance(state, zero.ZeroState):
        return True
    n = state.mesh.size

    def cut(shape, dim):
        shape = list(shape)
        if dim is not None:
            shape[dim] //= n
        return shape

    opt = state.optimizer
    names = [n for n, _ in state.model.named_parameters()]
    ok = all(list(opt.state[p][k].shape) == cut(snap.state_dict[n].shape,
                                                   state.dims[n])
             for n, p in zip(names, opt.param_groups[0]["params"])
             for k in ("exp_avg", "exp_avg_sq"))
    held = state.model.state_dict()
    ok = ok and all(list(held[n].shape) == (
        cut(snap.state_dict[n].shape, state.dims[n]) if state.fsdp
        else list(snap.state_dict[n].shape)) for n in held)
    return ok and (n == 1 or any(d is not None for d in state.dims.values()))


def layout_parity(mesh: mesh_lib.Mesh, cfg: SVSConfig,
                  batch: Dict[str, np.ndarray], layouts=LAYOUTS,
                  time_reps: int = 0) -> Optional[Dict[str, object]]:
    """One train step of the global host ``batch`` under each of
    ``layouts`` (``tp`` on a ``Mesh2D``, which the others take as its
    world) from the state of seed 0 and one dropout seed, through the
    step ``fit`` runs (the program of its key where
    ``graphs.mesh_programmed``, whose first call is the eager body).
    Returns on rank 0, by layout: the envelope's deltas against the
    unsharded step (rank 0, all-ones ``weight``), ``vs_dp`` (the largest
    |difference| of the metrics, the gathered state and Adam's moments
    from the DP step's; 0.0: the same bits), ``spread`` (of the gathered
    state over the ranks), ``shards_ok`` (:func:`_shards_ok`), ``bytes``
    (each rank's ``zero.state_bytes`` after the step, Adam's moments
    made), ``peak`` (each rank's ``torch.cuda.max_memory_allocated`` over
    the step, on a CUDA mesh), ``kernels`` (the loss kernels' launches in
    the step on rank 0: spectral_mag fwd / bwd, loss_partials fwd / bwd),
    the shapes of enc4's weight and moment on rank 0, ``programmed`` and
    ``programs`` (:func:`programs` of the step's state: none where the
    step ran eagerly); with ``time_reps`` on a CUDA mesh ``ms``, each
    rank's means of that many more steps by CUDA events (after two warm
    ones: a program's eager first call and its capture), and ``ref_ms``,
    rank 0's of the unsharded step, in turns (unsharded, each layout, each
    layout back, unsharded); where the steps are programs also
    ``eager_ms`` and ``ref_eager_ms``, the eager bodies' (``step.eager``)
    from their own states, timed beside them (the program first on the
    way there, the eager body first on the way back), and ``vs_eager``,
    the largest |difference| of each program's final state (parameters,
    BN, Adam's moments) from its eager body's after the same calls with
    the same dropout draws (0.0: the same bits; else None)."""
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl

    dev, seed = mesh.device, 0
    cuda = dev.type == "cuda"
    on = graphs.mesh_programmed(mesh)

    def local(kind):
        return layout_batch(kind, mesh, batch)

    out, full = {}, {}
    for kind in layouts:
        state, step = layout_state(kind, cfg, mesh, seed)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        cdm.reset_counts()
        cfl.reset_counts()
        state, metrics = step(state, local(kind),
                              torch.Generator(dev).manual_seed(seed + 1))
        kernels = _loss_kernel_counts()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        snap = zero.unshard_state(state)
        w = "conv4.0.weight"
        mu = dict(zip((n for n, _ in state.model.named_parameters()),
                      state.optimizer.param_groups[0]["params"]))[w]
        full[kind] = ({k: v.detach().cpu() for k, v in metrics.items()},
                      snap)
        out[kind] = {
            "spread": _spread(snap.state_dict, mesh),
            "shards_ok": _shards_ok(state, snap),
            "bytes": multihost.per_rank([zero.state_bytes(state)],
                                        mesh).ravel().tolist(),
            "peak": multihost.per_rank([peak], mesh).ravel().tolist(),
            "kernels": list(kernels),
            "enc4": [list(state.model.state_dict()[w].shape),
                     list(state.optimizer.state[mu]["exp_avg"].shape)],
            "programmed": on, "programs": programs(state.model),
            "vs_eager": None}
        del state, step
    ref_batch = tstep.batch_to_device(batch, dev)
    ref_batch["weight"] = torch.ones(len(batch["mix"]), device=dev)
    ref_step = tstep.make_train_step(cfg)
    if time_reps and cuda:
        runs = {k: (*layout_state(k, cfg, mesh, seed), local(k))
                for k in layouts}
        runs["ref"] = (tstep.create_train_state(seed, cfg, device=dev),
                       ref_step, ref_batch)
        forms = {"program": runs}
        if on:
            forms["eager"] = {
                k: (*layout_state(k, cfg, mesh, seed), local(k))
                for k in layouts}
            forms["eager"]["ref"] = (
                tstep.create_train_state(seed, cfg, device=dev), ref_step,
                ref_batch)
        gens = {(form, k): torch.Generator(dev).manual_seed(seed + 2)
                for form in forms for k in ("ref", *layouts)}
        order = ("ref", *layouts, *reversed(layouts), "ref")
        for i, kind in enumerate(order):
            if kind == "ref" and not mesh.is_primary:
                continue  # the others wait in the next layout's collectives
            back = i >= len(order) // 2
            for form in (sorted(forms) if back else sorted(forms)[::-1]):
                state, step, inp = forms[form][kind]
                run = step if form == "program" else step.eager
                gen = gens[(form, kind)]
                ms = _event_ms(lambda: run(state, inp, gen), dev, time_reps,
                               warmup=2 if on else 0)
                key = "ms" if form == "program" else "eager_ms"
                if kind == "ref":
                    out.setdefault("ref", {}).setdefault(key, []).append(ms)
                else:
                    out[kind].setdefault(key, []).append(
                        multihost.per_rank([ms], mesh).ravel().tolist())
        if on:
            for kind in layouts:
                got, want = (_full(forms[f][kind][0])
                             for f in ("program", "eager"))
                out[kind]["vs_eager"] = max(_max_diff(got[k], want[k])
                                            for k in ("sd", "mu", "nu"))
        del runs, forms
        ref = out.pop("ref", {})
        for kind in layouts:
            out[kind]["ref_ms"] = ref.get("ms", [])
            if on:
                out[kind]["ref_eager_ms"] = ref.get("eager_ms", [])
    if not mesh.is_primary:
        return None
    ref_state, ref = ref_step.eager(
        tstep.create_train_state(seed, cfg, device=dev), ref_batch,
        torch.Generator(dev).manual_seed(seed + 1))
    for kind in layouts:
        metrics, snap = full[kind]
        out[kind].update(envelope(metrics, snap.state_dict, ref, ref_state,
                                  cfg.learning_rate))
        if "dp" in full:
            dp_metrics, dp_snap = full["dp"]
            out[kind]["vs_dp"] = max(
                _max_diff(metrics, dp_metrics),
                _max_diff(snap.state_dict, dp_snap.state_dict),
                _max_diff(snap.exp_avg, dp_snap.exp_avg),
                _max_diff(snap.exp_avg_sq, dp_snap.exp_avg_sq))
    return out


def tp_parity(mesh: mesh_lib.Mesh, shape: Tuple[int, int], cfg: SVSConfig,
              batch: Dict[str, np.ndarray], layouts=("dp", "tp"),
              time_reps: int = 0) -> Optional[Dict[str, object]]:
    """:func:`layout_parity` on this pool's world viewed as the ``shape``
    ``(data, model)`` mesh (``mesh.make_2d_mesh``), TP beside DP over the
    same ranks by default."""
    mesh2d = mesh_lib.make_2d_mesh(*shape, device=mesh.device,
                                   backend=mesh.backend)
    return layout_parity(mesh2d, cfg, batch, layouts, time_reps)


def microbatch_oracle(state: tstep.TrainState, batch: Dict,
                      generator: Optional[torch.Generator], cfg: SVSConfig,
                      n_micro: int) -> Tuple[tstep.TrainState, Dict]:
    """The semantics the pipelined step promises (GPipe's, svs_tpu
    tests/test_pp.py:49), as a loop on the state's one device: each live
    microbatch (contiguous rows) through ``UNet.forward`` with its own
    generator (``pp.microbatch_generators``) and its own backward, the
    BatchNorm running statistics threaded in microbatch order, the mean
    gradient, one optimizer update in place.  A microbatch whose weight is
    all zero is skipped.  Returns the state and the mean metrics."""
    model = state.model.train()
    params = list(model.parameters())
    full = tstep.batch_to_device(batch, params[0].device)
    mb = len(batch["mix"]) // n_micro
    gens = pp.microbatch_generators(generator, n_micro)
    grads, aux = None, []
    for m in range(n_micro):
        sl = {k: v[m * mb:(m + 1) * mb] for k, v in full.items()}
        w = sl.get("weight")
        if w is not None and float(w.sum()) == 0.0:
            continue
        mask = model(sl["mix"], weight=w, generator=gens[m])
        total, parts = combined_loss(mask, sl["mix"], sl["voc"],
                                     sl["mix_angle"], sl["voc_angle"], cfg,
                                     weight=w)
        g = torch.autograd.grad(total, params)
        grads = list(g) if grads is None else [a + b for a, b in
                                                zip(grads, g)]
        aux.append(parts)
    n = len(aux)
    grads = [g / n for g in grads]
    metrics = {k: (sum(a[k] for a in aux) / n).detach() for k in aux[0]}
    metrics["grad_norm"] = tstep.global_norm(grads)
    tstep._apply(state, grads)
    state.step += 1
    return state, metrics


def pp_parity(devices, cfg: SVSConfig, batch: Dict[str, np.ndarray], *,
              n_micro: int = 1, split: int = 3) -> Dict[str, object]:
    """One PP step of the host ``batch`` on the stage ``devices`` from the
    state of seed 0 and the dropout seed 1, against the step on stage 0's
    device from the same state and generator: ``make_train_step``'s at
    ``n_micro = 1``, else :func:`microbatch_oracle`.  Returns the
    :func:`envelope` of the two, ``bits`` (the largest |difference| of
    the metrics and the state dicts; 0.0: the same bits), ``kernels`` (the
    loss kernels' launches in the PP step) and ``stage_bytes`` (each
    stage's resting state after it); where the step is a program
    (``pp.programmed``), :func:`pp_program_parity` over three calls of the
    batch (``vs_eager``, ``programmed``, ``programs``, at ``n_micro = 1``
    ``vs_single``), else ``programmed`` False."""
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl

    devs = pp.make_pp_mesh(devices)
    dev = devs[0]

    def fresh():
        return tstep.create_train_state(0, cfg, device=dev)

    state = pp.shard_state(fresh(), devs, split=split)
    step = pp.make_pp_train_step(devs, cfg, n_micro=n_micro, split=split)
    cdm.reset_counts()
    cfl.reset_counts()
    state, metrics = step(state, batch, torch.Generator(dev).manual_seed(1))
    kernels = list(_loss_kernel_counts())
    got = pp.gather_state(state)
    ref_gen = torch.Generator(dev).manual_seed(1)
    if n_micro == 1:
        ref_state, ref = tstep.make_train_step(cfg)(
            fresh(), tstep.batch_to_device(batch, dev), ref_gen)
    else:
        ref_state, ref = microbatch_oracle(fresh(), batch, ref_gen, cfg,
                                           n_micro)
    lr = float(ref_state.optimizer.param_groups[0]["lr"])
    out = envelope(metrics, got, ref, ref_state, lr)
    out["bits"] = max(_max_diff({k: v.cpu() for k, v in metrics.items()},
                                {k: v.cpu() for k, v in ref.items()}),
                      _max_diff(got.model.state_dict(),
                                ref_state.model.state_dict()))
    out["kernels"] = kernels
    out["stage_bytes"] = pp.stage_bytes(state)
    if pp.programmed(devs):
        out.update(pp_program_parity(devs, cfg, [batch] * 3,
                                     n_micro=n_micro, split=split,
                                     single=n_micro == 1))
    else:
        out.update(vs_eager=None, programmed=False, programs=[])
    return out


def pp_program_parity(devices, cfg: SVSConfig, batches: List[Dict], *,
                      n_micro: int = 1, split: int = 3, seed: int = 0,
                      single: bool = False) -> Dict[str, object]:
    """PP's train step over the stage ``devices`` (the program of its key
    where ``pp.programmed``) against its eager form (``step.eager``), each
    from the state of ``seed`` with a dropout generator of ``seed + 1``,
    over ``batches``: ``vs_eager``, the largest |difference| of any call's
    metrics, of the full state after the last (parameters, BN, Adam's
    moments) and of the generators' states (0.0: the same bits),
    ``programmed`` and ``programs`` (:func:`programs`; none where the step
    ran eagerly).  ``single`` (``n_micro = 1``): also ``vs_single``, the
    same against ``make_train_step`` (a program where the single step is
    one) on stage 0's device over the same batches."""
    devs = pp.make_pp_mesh(devices)
    forms = ("program", "eager") + (("single",) if single else ())
    got = []
    for form in forms:
        state = tstep.create_train_state(seed, cfg, device=devs[0])
        if form == "single":
            step = tstep.make_train_step(cfg)
            calls = [tstep.batch_to_device(b, devs[0]) for b in batches]
        else:
            state = pp.shard_state(state, devs, split=split)
            step = pp.make_pp_train_step(devs, cfg, n_micro=n_micro,
                                         split=split)
            calls = batches
        run = step.eager if form == "eager" else step
        gen = torch.Generator(devs[0]).manual_seed(seed + 1)
        metrics = [{k: v.cpu() for k, v in run(state, b, gen)[1].items()}
                   for b in calls]
        progs = programs(state.model) if form == "program" else None
        if isinstance(state, pp.PPState):
            state = pp.gather_state(state)
        got.append((metrics, _full(state), gen.get_state(), progs))
        del state, step
    graphs.CACHE.clear()

    def diff(a, b):
        (am, afull, agen, _), (bm, bfull, bgen, _) = a, b
        return max([_max_diff(x, y) for x, y in zip(am, bm)]
                   + [_max_diff(afull[k], bfull[k])
                      for k in ("sd", "mu", "nu")]
                   + [float((agen != bgen).any())])

    out = {"vs_eager": diff(got[0], got[1]), "programmed": pp.programmed(devs),
           "programs": got[0][3], "calls": len(batches)}
    if single:
        out["vs_single"] = diff(got[0], got[2])
    return out


def sp_parity(mesh: mesh_lib.Mesh, model: torch.nn.Module, mag: np.ndarray
              ) -> Optional[Dict[str, float]]:
    """``separate_magnitude_mesh`` against ``separate_magnitude`` in both
    SP modes: the max |difference| of each, on rank 0 (None elsewhere);
    and ``vs_eager``, the largest |difference| on any rank between each
    rank's mask (``dp.make_sp_separate``, the program of its key where
    ``separate._programmed``) and its eager body, both ways of
    ``vocal_solo``, on a block of 8 windows (0.0: the same bits), with
    ``programmed``."""
    from svs_torch.infer import separate

    out = {}
    for mode in ("segments", "overlap"):
        got = separate.separate_magnitude_mesh(model, mag, mesh, mode=mode)
        if mesh.is_primary:
            want = separate.separate_magnitude(model, mag, mode=mode,
                                               device=mesh.device)
            out[mode] = float(np.abs(got - want).max())
    vs_eager = _host_max(sp_program_parity(mesh, model), mesh)
    if not mesh.is_primary:
        return None
    return dict(out, vs_eager=vs_eager,
                programmed=separate._programmed(mesh.device))


def sp_decode_parity(mesh: mesh_lib.Mesh, cfg: SVSConfig, mag: np.ndarray
                     ) -> Optional[Dict[str, float]]:
    """:func:`sp_parity` of the eval-mode U-Net of seed 0 on the mesh's
    device (a pool's ranks make their own model)."""
    from svs_torch.models.unet import UNet

    model = UNet(cfg, generator=torch.Generator().manual_seed(0))
    return sp_parity(mesh, model.to(mesh.device).eval(), mag)


def sp_program_parity(mesh: mesh_lib.Mesh, model: torch.nn.Module,
                      windows: int = 8, seed: int = 7) -> float:
    """This rank's SP mask (``dp.make_sp_separate``) of ``windows`` random
    windows of the model's ``input_len`` frames, both ways of
    ``vocal_solo``, against its eager body: the largest |difference|
    (0.0: the same bits)."""
    segs = torch.rand((windows, model.cfg.freq_bins, model.cfg.input_len),
                      generator=torch.Generator().manual_seed(
                          seed + mesh.rank))
    diff = 0.0
    for solo in (True, False):
        fn = dp.make_sp_separate(mesh, model.cfg, vocal_solo=solo)
        diff = max(diff, float((fn(model, segs) - fn.eager(model, segs))
                               .abs().max()))
    return diff


def first_ranks(mesh: mesh_lib.Mesh, n: Optional[int]
                ) -> Optional[mesh_lib.Mesh]:
    """The mesh of ``mesh``'s first ``n`` ranks on those ranks, None on the
    others (``mesh`` itself where ``n`` is None or its size): one pool of
    ranks checks several world sizes.  A collective: every rank calls it
    at the same point."""
    if n is None or n == mesh.size:
        return mesh
    if not 0 < n < mesh.size:
        raise ValueError(f"{n} of {mesh.size} ranks")
    groups = [list(range(n)), list(range(n, mesh.size))]
    sub = mesh_lib._sub_mesh(mesh, groups, mesh.axis_name)
    return sub if mesh.rank < n else None


def cp_parity(mesh: mesh_lib.Mesh, cfg: SVSConfig,
              batch: Dict[str, np.ndarray], first: Optional[int] = None
              ) -> Optional[Dict[str, object]]:
    """One CP train step of the host ``batch`` (its time axis cut over the
    mesh, or its ``first`` ranks', :func:`first_ranks`;
    ``halo.shard_batch_time``) from the state of seed 0 and the
    dropout seed 1, against ``make_train_step`` of the whole batch (with
    an all-ones ``weight``) from the same state and generator on rank 0.
    Returns on rank 0 the :func:`envelope` of the two, ``bits`` (the
    largest |difference| of the metrics and the state dicts; 0.0: the same
    bits), ``spread`` (of the state over the ranks), ``kernels`` (the loss
    kernels' launches in the CP step on rank 0), ``peak`` (each rank's
    ``torch.cuda.max_memory_allocated`` over the step, on a CUDA mesh),
    ``programmed`` and ``programs`` (:func:`layout_parity`'s); None
    elsewhere."""
    mesh = first_ranks(mesh, first)
    if mesh is None:
        return None
    dev = mesh.device
    cuda = dev.type == "cuda"
    state, step = layout_state("cp", cfg, mesh)
    local = halo.shard_batch_time(mesh, batch)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl
    cdm.reset_counts()
    cfl.reset_counts()
    state, metrics = step(state, local, torch.Generator(dev).manual_seed(1))
    kernels = list(_loss_kernel_counts())
    peak = multihost.per_rank(
        [torch.cuda.max_memory_allocated(dev) if cuda else 0],
        mesh).ravel().tolist()
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    spread = _spread(sd, mesh)
    on = graphs.mesh_programmed(mesh)
    progs = programs(state.model)
    if not mesh.is_primary:
        return None
    ref_batch = tstep.batch_to_device(batch, dev)
    ref_batch["weight"] = torch.ones(len(batch["mix"]), device=dev)
    ref_state, ref = tstep.make_train_step(cfg)(
        tstep.create_train_state(0, cfg, device=dev), ref_batch,
        torch.Generator(dev).manual_seed(1))
    metrics = {k: v.cpu() for k, v in metrics.items()}
    out = envelope(metrics, sd, ref, ref_state, cfg.learning_rate)
    out["bits"] = max(_max_diff(metrics, {k: v.cpu() for k, v in
                                          ref.items()}),
                      _max_diff(sd, {k: v.cpu() for k, v in
                                     ref_state.model.state_dict().items()}))
    out.update(spread=spread, kernels=kernels, peak=peak, programmed=on,
               programs=progs)
    return out


def cp_decode_parity(mesh: mesh_lib.Mesh, cfg: SVSConfig, mag: np.ndarray,
                     reps: int = 0, first: Optional[int] = None
                     ) -> Optional[Dict[str, object]]:
    """The whole-song CP decode (``separate_magnitude_mesh(mode="whole")``)
    over the mesh, or its ``first`` ranks (:func:`first_ranks`), of ``mag``
    by the eval-mode U-Net of seed 0, against the unsharded
    ``separate_magnitude(mode="whole")`` on rank 0: ``max_abs_err``
    (it pads to ``8 * input_len`` frames, CP to ``64 * size``: the two
    agree where those paddings do), and ``padded_err`` against the
    unsharded forward of the song zero-padded as CP pads it (svs_tpu's
    ``separate_magnitude_time_sharded``); on a
    CUDA mesh with ``reps`` also ``ms`` (each rank's mean of ``reps`` more
    CP decodes by CUDA events, host copies included) and ``peak`` (each
    rank's ``torch.cuda.max_memory_allocated`` over one CP decode), and
    ``ref_ms`` and ``ref_peak``, rank 0's of the unsharded decode, taken
    after; ``vs_eager``, the largest |difference| on any rank between the
    time-sharded mask (``halo.make_time_sharded_apply``, the program of its
    key where ``separate._routed`` over the mesh) and its eager body (0.0: the
    same bits), with ``programmed``, and with ``reps`` on a CUDA mesh
    ``mask_ms`` / ``mask_eager_ms``, each rank's mean of ``reps`` calls of
    each by CUDA events.  None elsewhere."""
    from svs_torch.infer import separate
    from svs_torch.models.unet import UNet

    mesh = first_ranks(mesh, first)
    if mesh is None:
        return None
    dev = mesh.device
    model = UNet(cfg, generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()

    def cp():
        return separate.separate_magnitude_mesh(model, mag, mesh,
                                                mode="whole")

    def one():
        return separate.separate_magnitude(model, mag, mode="whole",
                                           device=dev)

    @torch.inference_mode()
    def padded():
        t = mag.shape[1]
        g = halo.granule(mesh)
        mag_p = np.pad(mag.astype(np.float32),
                       ((0, 0), (0, -(-max(t, g) // g) * g - t)))
        mask = model(torch.from_numpy(mag_p[None, 1:]).to(dev))[0]
        return np.concatenate([np.zeros_like(mag_p[:1]),
                               mag_p[1:] * mask.cpu().numpy()])[:, :t]

    def timed(fn):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        peak = torch.cuda.max_memory_allocated(dev)
        return _event_ms(fn, dev, reps), peak

    got = cp()
    out = {}
    if reps and dev.type == "cuda":
        ms, peak = timed(cp)
        out.update(ms=multihost.per_rank([ms], mesh).ravel().tolist(),
                   peak=multihost.per_rank([peak], mesh).ravel().tolist())
    t = mag.shape[1]
    g = halo.granule(mesh)
    mix = np.pad(mag.astype(np.float32),
                 ((0, 0), (0, -(-max(t, g) // g) * g - t)))[None, 1:]
    apply = halo.make_time_sharded_apply(mesh)
    out["vs_eager"] = _host_max(float(
        (apply(model, mix) - apply.eager(model, mix)).abs().max()), mesh)
    out["programmed"] = separate._routed(mesh.device, mesh)
    if reps and dev.type == "cuda":
        for key, fn in (("mask_ms", apply), ("mask_eager_ms", apply.eager)):
            out[key] = multihost.per_rank(
                [_event_ms(lambda: fn(model, mix), dev, reps, 1)],
                mesh).ravel().tolist()
    if not mesh.is_primary:
        return None
    if reps and dev.type == "cuda":
        out["ref_ms"], out["ref_peak"] = timed(one)
    out["max_abs_err"] = float(np.abs(got - one()).max())
    out["padded_err"] = float(np.abs(got - padded()).max())
    return out


def as_hosts(mesh: mesh_lib.Mesh, hosts: int) -> mesh_lib.Mesh:
    """``mesh``'s ranks viewed as ``hosts`` hosts of consecutive ranks (the
    same process group): one pool checks the multi-host layer."""
    if mesh.size % hosts:
        raise ValueError(f"{mesh.size} ranks do not split into {hosts} "
                         "hosts")
    return dataclasses.replace(mesh, hosts=hosts)


def host_batches(batch: Dict[str, np.ndarray], hosts: int
                 ) -> Tuple[List[Dict[str, np.ndarray]], int]:
    """A global batch cut into ``hosts`` local batches of ``local_bs =
    ceil(B / hosts)`` rows each (the last with the rows that are left),
    and ``local_bs``."""
    b = len(next(iter(batch.values())))
    local = -(-b // hosts)
    return [{k: v[h * local:(h + 1) * local] for k, v in batch.items()}
            for h in range(hosts)], local


def host_major(locals_: List[Dict[str, np.ndarray]], pad_to: int
               ) -> Dict[str, np.ndarray]:
    """The global batch of several hosts' local batches: each padded to
    ``pad_to`` rows with zero rows, host after host, with the 0/1
    ``weight`` (svs_tpu's ``global_batch_from_local`` across processes)."""
    out = {k: [] for k in locals_[0]}
    out["weight"] = []
    for b in locals_:
        n = len(next(iter(b.values())))
        for k, v in b.items():
            out[k].append(np.concatenate(
                [v, np.zeros((pad_to - n,) + v.shape[1:], v.dtype)]))
        out["weight"].append(np.concatenate(
            [np.ones(n, np.float32), np.zeros(pad_to - n, np.float32)]))
    return {k: np.concatenate(v) for k, v in out.items()}


def state_digest(state) -> str:
    """SHA-256 of a state's full state dict (gathered where sharded), in
    one order on every rank: two states of the same bits have one
    digest."""
    snap = zero.unshard_state(state)
    h = hashlib.sha256()
    for k in sorted(snap.state_dict):
        h.update(k.encode())
        h.update(snap.state_dict[k].detach().cpu().contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


def mh_parity(mesh: mesh_lib.Mesh, cfg: SVSConfig,
              batch: Dict[str, np.ndarray]) -> Optional[Dict[str, object]]:
    """One DP step over several hosts: ``mesh`` (of one host, viewed as 2
    by :func:`as_hosts`), each host's share of the global host ``batch``
    (:func:`host_batches`) cut into its ranks' blocks by
    ``multihost.global_batch_from_local`` at the loop's ``pad_to``, from
    the state of seed 0 and the dropout seed 1.  Returns on rank 0 the
    :func:`envelope` of the step against ``make_train_step`` of the
    host-major padded global batch (:func:`host_major`) from the same
    state and generator, ``bits`` (the largest |difference| of the
    metrics and the state dicts), ``spread`` (of the state over the
    ranks), ``kernels`` (the loss kernels' launches in the step on rank
    0), ``peak`` (each rank's ``torch.cuda.max_memory_allocated`` over the
    step, on a CUDA mesh), ``rows`` (the hosts' real rows) and
    ``pad_to``; None elsewhere."""
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl

    mesh = mesh if mesh.hosts > 1 else as_hosts(mesh, 2)
    dev = mesh.device
    cuda = dev.type == "cuda"
    locals_, local_bs = host_batches(batch, mesh.hosts)
    pad_to = multihost.pad_rows(local_bs, mesh)
    state = dp.replicate_state(tstep.create_train_state(0, cfg, device=dev),
                               mesh)
    step = dp.make_dp_train_step(mesh, cfg)
    inp = multihost.global_batch_from_local(mesh, locals_[mesh.host],
                                            pad_to)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cdm.reset_counts()
    cfl.reset_counts()
    state, metrics = step(state, inp, torch.Generator(dev).manual_seed(1))
    kernels = list(_loss_kernel_counts())
    peak = multihost.per_rank(
        [torch.cuda.max_memory_allocated(dev) if cuda else 0],
        mesh).ravel().tolist()
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    spread = _spread(sd, mesh)
    if not mesh.is_primary:
        return None
    ref_state, ref = tstep.make_train_step(cfg)(
        tstep.create_train_state(0, cfg, device=dev),
        tstep.batch_to_device(host_major(locals_, pad_to), dev),
        torch.Generator(dev).manual_seed(1))
    metrics = {k: v.cpu() for k, v in metrics.items()}
    out = envelope(metrics, sd, ref, ref_state, cfg.learning_rate)
    out["bits"] = max(_max_diff(metrics, {k: v.cpu() for k, v in
                                          ref.items()}),
                      _max_diff(sd, {k: v.cpu() for k, v in
                                     ref_state.model.state_dict().items()}))
    out.update(spread=spread, kernels=kernels, peak=peak, pad_to=pad_to,
               rows=[len(b["mix"]) for b in locals_])
    return out


def mh_data_parity(mesh: mesh_lib.Mesh, folder: str, cfg: SVSConfig,
                   local_bs: int, n_steps: Optional[int] = None
                   ) -> Dict[str, object]:
    """``MultiHostDeviceDataset`` against the host pipeline on this rank:
    the host's round-robin share of ``folder``'s songs, its index stream
    at ``local_bs`` and the seed ``MH_SEED`` (``n_steps`` full batches,
    or the epoch with its ragged tail), and each batch's block against
    ``multihost.global_batch_from_local`` of the host's numpy batch.
    Returns ``equal`` (every plane and ``weight`` the same bits),
    ``batches`` and ``rows`` (the host batches' real rows)."""
    from svs_torch.data.dataset import PatchDataset
    from svs_torch.data.device_data import MultiHostDeviceDataset

    ds = PatchDataset(folder, samples_per_song=cfg.samples_per_song,
                      input_len=cfg.input_len)
    multihost.shard_songs(ds, mesh.host, mesh.hosts)
    pad_to = multihost.pad_rows(local_bs, mesh)
    feed = MultiHostDeviceDataset(ds, mesh, pad_to)
    equal, rows = True, []
    for h, d in zip(ds.batches(local_bs, seed=MH_SEED, n_steps=n_steps),
                    feed.batches(local_bs, seed=MH_SEED, n_steps=n_steps)):
        want = multihost.global_batch_from_local(mesh, h, pad_to)
        equal = equal and sorted(d) == sorted(want) and all(
            torch.equal(d[k], want[k]) for k in want)
        rows.append(len(h["mix"]))
    return {"equal": equal, "batches": len(rows), "rows": rows,
            "songs": ds.n_songs}


def mh_augment_parity(mesh: mesh_lib.Mesh, batch: Dict[str, np.ndarray],
                      n_real: int, hosts: int = 1) -> Dict[str, float]:
    """``Augmenter.apply_sharded`` on this rank's block of its host's
    padded ``batch`` (the same on every host; ``mesh`` viewed as
    ``hosts`` hosts) at the epoch seed ``MH_SEED`` against the numpy
    oracle: the host generator replayed
    shard by shard in row order, a shard without real rows drawing
    nothing (svs_tpu's ``apply_sharded``).  Returns ``max_err`` by plane
    (a magnitude's largest |difference| over the oracle's largest |value|,
    an angle's largest |difference| modulo 2 pi, in radians: float32 and
    the oracle's float64 may take a sum that is ~0 to either side of the
    branch cut), ``pads_zero`` (the pad rows exactly zero), ``untouched``
    (a block without real rows returned as given) and ``in_step`` (the
    generators at one point after)."""
    from svs_torch.data.augment import (Augmenter, apply_remix_np,
                                        draw_vectors)

    mesh = as_hosts(mesh, hosts)
    q = len(batch["mix"]) // mesh.local_size
    lo = mesh.local_rank * q
    block = {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + q])).to(
        mesh.device) for k, v in batch.items()}
    aug = Augmenter(remix_p=0.8).for_epoch(MH_SEED)
    got = aug.apply_sharded(block, n_real, mesh=mesh)
    rng = np.random.default_rng(MH_SEED * 1_000_003 + 17)
    want = {k: v[lo:lo + q] for k, v in batch.items()}
    for i in range(mesh.local_size):
        n_i = min(q, max(0, n_real - i * q))
        if n_i == 0:
            break
        draws = draw_vectors(rng, n_i, q, 0.8, 0.25, 1.25)
        if i == mesh.local_rank:
            want = apply_remix_np(want, *draws)
    def err(k):
        d = got[k].cpu().numpy().astype(np.float64) - want[k]
        if k.endswith("angle"):
            return float(np.abs((d + np.pi) % (2 * np.pi) - np.pi).max())
        return float(np.abs(d).max()
                     / max(float(np.abs(want[k]).max()), 1e-30))

    planes = ("mix", "mix_angle", "voc", "voc_angle")
    real = min(q, max(0, n_real - lo))
    return {
        "max_err": {k: err(k) for k in planes},
        "pads_zero": all(not got[k][real:].any() for k in planes),
        "untouched": real > 0 or got is block,
        "in_step": bool(aug._rng.uniform() == rng.uniform())}


def mh_fit(mesh: mesh_lib.Mesh, opts_kw: Dict, cfg: SVSConfig,
           load_paths: Optional[List[str]] = None) -> Dict[str, object]:
    """``fit`` over ``mesh`` (``TrainOptions(mesh=mesh, **opts_kw)``;
    ``load_paths``: each host's ``load_path``): this rank's host, step
    count and :func:`state_digest` after it."""
    from svs_torch.train import loop

    if load_paths is not None:
        opts_kw = dict(opts_kw, load_path=load_paths[mesh.host])
    state = loop.fit(loop.TrainOptions(mesh=mesh, **opts_kw), cfg)
    return {"host": mesh.host, "steps": state.step,
            "digest": state_digest(state)}


def scan_refusal(mesh: mesh_lib.Mesh, opts_kw: Dict, cfg: SVSConfig
                 ) -> Dict[str, object]:
    """``fit`` with ``epoch_scan`` over ``mesh``: the ``ValueError`` it
    raised (None if it trained), whether it had made its checkpoint folder
    by then (``fit`` makes it after its refusals, before any step) and the
    bytes this rank then held on its device."""
    from svs_torch.train import loop

    said = None
    try:
        loop.fit(loop.TrainOptions(mesh=mesh, epoch_scan=True, **opts_kw),
                 cfg)
    except ValueError as e:
        said = str(e)
    held = (torch.cuda.memory_allocated(mesh.device)
            if mesh.device.type == "cuda" else 0)
    return {"refused": said, "made_dirs": os.path.exists(opts_kw["ckpt_dir"]),
            "bytes": held}


def sharded_layouts(n: int) -> tuple:
    """The layouts the dry run checks over ``n`` ranks: ZeRO-1 and FSDP
    where ``n > 1`` and ``128 % n == 0`` (``dryrun_multichip``'s guard:
    the channel rule must find channels to cut)."""
    return ("zero1", "fsdp") if n > 1 and 128 % n == 0 else ()


def tp_mesh(n: int) -> Optional[Tuple[int, int]]:
    """The ``(data, model)`` mesh the dry run checks TP on over ``n``
    ranks: ``(2, n / 2)`` where ``n >= 4`` and ``n`` is even
    (``dryrun_multichip``'s guard), else None."""
    return (2, n // 2) if n >= 4 and n % 2 == 0 else None


def dp_smoke_rank(mesh: mesh_lib.Mesh) -> Optional[Dict[str, object]]:
    """The dry run's checks on one rank (see the module's docstring);
    rank 0 returns their numbers."""
    cfg = SVSConfig(input_len=64, dropout_rate=0.5)
    batch = dry_batch(mesh.size)
    step = layout_parity(mesh, cfg, batch,
                         ("dp",) + sharded_layouts(mesh.size))
    if tp_mesh(mesh.size):
        tp_step = tp_parity(mesh, tp_mesh(mesh.size), cfg, batch, ("tp",))
        if mesh.is_primary:
            step.update(tp_step)
    model = tstep.create_train_state(0, cfg, device=mesh.device).model
    mag = np.abs(np.random.default_rng(3).standard_normal(
        (513, 150))).astype(np.float32)
    sp = sp_parity(mesh, model.eval(), mag)
    frames = halo.granule(mesh)
    cp_step = cp_parity(mesh, cfg, dry_batch(2, frames))
    song = np.random.default_rng(5).random(
        (513, math.lcm(frames, 8 * cfg.input_len)), np.float32)
    cp_decode = cp_decode_parity(mesh, cfg, song)
    mh = (mh_parity(mesh, cfg, dry_batch(mesh.size + 1))
          if mesh.size % 2 == 0 else None)
    if not mesh.is_primary:
        return None
    out = dict(step, sp=sp, cp=cp_step,
               cp_decode=dict(cp_decode, frames=song.shape[1]))
    if mh is not None:
        out["multihost"] = mh
    return out


def dp_smoke(devices: int = 8, timeout: float = 1200.0) -> Dict[str, object]:
    """The dry run over ``devices`` gloo ranks on the CPU: svs_tpu's JSON
    line."""
    from svs_torch.parallel.launch import Ranks

    t0 = time.perf_counter()
    try:
        with Ranks(devices, device="cpu", backend="gloo",
                   timeout=timeout) as ranks:
            res = ranks.run(dp_smoke_rank)[0]
        sp = res.pop("sp")
        cp_decode = res.pop("cp_decode")
        if devices >= 2:  # in this process: two stages on the host
            res["pp"] = pp_parity(("cpu", "cpu"),
                                  SVSConfig(input_len=64, dropout_rate=0.5),
                                  dry_batch(devices))
        ok = all(sp[m] <= SP_ATOL for m in ("segments", "overlap")) \
            and cp_decode["max_abs_err"] <= CP_ATOL \
            and sp["vs_eager"] == 0.0 and cp_decode["vs_eager"] == 0.0
        parts = []
        for kind, step in res.items():
            if kind == "cp":
                ok = ok and step["ok"] and step["spread"] == 0.0
                parts.append(
                    f"cp == unsharded step (loss rel {step['loss_rel']:.2e}, "
                    f"grad_norm rel {step['grad_norm_rel']:.2e}, bn "
                    f"{step['bn_abs']:.2e}, params max "
                    f"{step['params_max']:.2e} mean "
                    f"{step['params_mean']:.2e}; rank spread "
                    f"{step['spread']:g}; B = 2 x {64 * devices} frames, "
                    "64 a rank); cp decode == unsharded whole decode "
                    f"(max {cp_decode['max_abs_err']:.2e}, "
                    f"{cp_decode['frames']} frames)")
                continue
            if kind == "multihost":
                ok = ok and step["ok"] and step["spread"] == 0.0
                parts.append(
                    f"multihost == unsharded step of the host-major padded "
                    f"batch (loss rel {step['loss_rel']:.2e}, grad_norm rel "
                    f"{step['grad_norm_rel']:.2e}, bn {step['bn_abs']:.2e}, "
                    f"params max {step['params_max']:.2e} mean "
                    f"{step['params_mean']:.2e}; rank spread "
                    f"{step['spread']:g}; 2 hosts of {devices // 2} ranks, "
                    f"host rows {step['rows']} padded to {step['pad_to']})")
                continue
            if kind == "pp":
                ok = ok and step["ok"]
                parts.append(
                    f"pp == unsharded step (loss {step['total']:.6f} vs "
                    f"{step['ref_total']:.6f}, rel {step['loss_rel']:.2e}, "
                    f"params max {step['params_max']:.2e} mean "
                    f"{step['params_mean']:.2e}; 2 stages on cpu, split 3, "
                    f"n_micro 1, stage bytes {step['stage_bytes']})")
                continue
            ok = ok and step["ok"] and step["spread"] == 0.0 \
                and step["shards_ok"]
            if kind == "tp":
                # the rule cuts enc4's 128 output channels n / 2 ways
                ok = ok and step["enc4"][0][0] == 128 // tp_mesh(devices)[1]
            parts.append(
                f"{kind} == unsharded step (loss rel "
                f"{step['loss_rel']:.2e}, grad_norm rel "
                f"{step['grad_norm_rel']:.2e}, bn {step['bn_abs']:.2e}, "
                f"params max {step['params_max']:.2e} mean "
                f"{step['params_mean']:.2e}; rank spread {step['spread']:g}"
                + ("" if kind == "dp" else
                   f"; enc4 weight / moment held {step['enc4'][0]} / "
                   f"{step['enc4'][1]}, state bytes a rank "
                   f"{step['bytes'][0]:.0f} against dp's "
                   f"{res['dp']['bytes'][0]:.0f}")
                + (f"; mesh {tp_mesh(devices)}" if kind == "tp" else "")
                + ")")
        skipped = [k for k in ("zero1", "fsdp") if k not in res]
        # the steps fit runs: programs where graphs.mesh_programmed, each
        # then held against its eager body
        for kind, step in res.items():
            if "programmed" in step:
                ok = ok and step.get("vs_eager") in (None, 0.0)
        parts.append("programs: " + ", ".join(
            f"{k} " + (f"vs eager {step.get('vs_eager')}"
                       if step["programmed"] else "none (eager bodies)")
            for k, step in res.items() if "programmed" in step))
        detail = (f"checked {list(CHECKED)}: " + "; ".join(parts)
                  + "; sp == unsharded decode (max "
                  + ", ".join(f"{k} {sp[k]:.2e}"
                              for k in ("segments", "overlap")) + ")"
                  + "; decode programs: sp " + (
                      f"vs eager {sp['vs_eager']}" if sp["programmed"]
                      else "none (eager bodies)") + ", cp " + (
                      f"vs eager {cp_decode['vs_eager']}"
                      if cp_decode["programmed"] else "none (eager bodies)")
                  + (f"; {skipped} skipped (needs devices > 1 dividing "
                     "128)" if skipped else "")
                  + ("" if "tp" in res else "; ['tp'] skipped (needs an "
                     "even count of devices >= 4)")
                  + ("" if "pp" in res else "; ['pp'] skipped (needs "
                     "devices >= 2)")
                  + ("" if "multihost" in res else "; ['multihost'] "
                     "skipped (needs an even count of devices >= 2)")
                  + f"; not ported: {list(NOT_PORTED)}")
    except Exception as e:  # the line reports the failure
        ok, detail = False, f"{type(e).__name__}: {str(e)[-2000:]}"
    return {"metric": "dp_smoke", "ok": bool(ok), "devices": devices,
            "wall_s": round(time.perf_counter() - t0, 1), "detail": detail}

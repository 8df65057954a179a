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
- the segment-parallel decode (``separate_magnitude_mesh``, both modes)
  against ``separate_magnitude`` on rank 0.

It returns svs_tpu's JSON line (``metric``, ``ok``, ``devices``,
``wall_s``, ``detail``); ``detail`` names the layouts checked and those not
ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from svs_torch.parallel import dp
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.parallel import zero
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
CHECKED = ("dp", "sp", "zero1", "fsdp")
NOT_PORTED = ("tp", "pp", "cp", "multihost")
# the training layouts of one data mesh
LAYOUTS = ("dp", "zero1", "fsdp")
# the SP decode's atol against the unsharded one (tests/test_infer_mesh.py)
SP_ATOL = 2e-5


def dry_batch(b: int) -> Dict[str, np.ndarray]:
    """The dry run's random global batch of 64-frame patches
    (``dryrun_multichip``'s draws)."""
    rng = np.random.default_rng(0)
    return {
        "mix": rng.random((b, 512, 64), np.float32),
        "voc": rng.random((b, 512, 64), np.float32) * 0.5,
        "mix_angle": (rng.random((b, 512, 64), np.float32) - 0.5) * 6,
        "voc_angle": (rng.random((b, 512, 64), np.float32) - 0.5) * 6,
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


def _event_ms(step, dev, reps: int, seed: int) -> float:
    """The mean of ``reps`` calls of ``step(generator)`` by CUDA events."""
    gen = torch.Generator(dev).manual_seed(seed + 2)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step(gen)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def layout_state(kind: str, cfg: SVSConfig, mesh: mesh_lib.Mesh,
                 seed: int = 0, state: Optional[tstep.TrainState] = None):
    """The state of ``seed`` (or ``state``, rank 0's) on every rank in
    layout ``kind`` (``dp``, ``zero1``, ``fsdp``) and its train step."""
    state = dp.replicate_state(
        state or tstep.create_train_state(seed, cfg, device=mesh.device),
        mesh)
    if kind == "dp":
        return state, dp.make_dp_train_step(mesh, cfg)
    fsdp = kind == "fsdp"
    return (zero.shard_state(state, mesh, fsdp=fsdp),
            zero.make_zero1_train_step(mesh, cfg, fsdp=fsdp))


def _per_rank(value: float, mesh: mesh_lib.Mesh) -> list:
    """Every rank's ``value``, in rank order."""
    if not mesh_lib.crosses(mesh):
        return [value]
    t = torch.zeros(mesh.size, dtype=torch.float64)
    t[mesh.rank] = value
    dist.all_reduce(t, group=mesh.host_group or mesh.group)
    return t.tolist()


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


def _shards_ok(state, snap, mesh: mesh_lib.Mesh) -> bool:
    """Whether each parameter's moments (and under FSDP the parameter and
    the running statistics) this rank holds are the channel rule's slice
    of the full leaf, and at least one leaf is cut where the mesh has
    more than one rank."""
    if not isinstance(state, zero.ZeroState):
        return True

    def cut(shape, dim):
        shape = list(shape)
        if dim is not None:
            shape[dim] //= mesh.size
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
    return ok and (mesh.size == 1 or any(
        d is not None for d in state.dims.values()))


def layout_parity(mesh: mesh_lib.Mesh, cfg: SVSConfig,
                  batch: Dict[str, np.ndarray], layouts=LAYOUTS,
                  time_reps: int = 0) -> Optional[Dict[str, object]]:
    """One train step of the global host ``batch`` under each of
    ``layouts`` from the state of seed 0 and one dropout seed.  Returns on
    rank 0, by layout: the envelope's deltas against the unsharded step
    (rank 0, all-ones ``weight``), ``vs_dp`` (the largest |difference| of
    the metrics, the gathered state and Adam's moments from the DP step's;
    0.0: the same bits), ``spread`` (of the gathered state over the
    ranks), ``shards_ok`` (:func:`_shards_ok`), ``bytes`` (each rank's
    ``zero.state_bytes`` after the step, Adam's moments made), ``peak``
    (each rank's ``torch.cuda.max_memory_allocated`` over the step, on a
    CUDA mesh), ``kernels`` (the loss kernels' launches in the step on
    rank 0: spectral_mag fwd / bwd, loss_partials fwd / bwd) and the
    shapes of enc4's weight and moment on rank 0; with ``time_reps`` on a
    CUDA mesh ``ms``, each rank's means of that many more steps by CUDA
    events, and ``ref_ms``, rank 0's of the unsharded step, in turns
    (unsharded, each layout, each layout back, unsharded).  None
    elsewhere."""
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl

    dev, seed = mesh.device, 0
    cuda = dev.type == "cuda"
    local = mesh_lib.shard_batch(mesh, batch)
    out, full = {}, {}
    for kind in layouts:
        state, step = layout_state(kind, cfg, mesh, seed)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        cdm.reset_counts()
        cfl.reset_counts()
        state, metrics = step(state, local,
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
            "shards_ok": _shards_ok(state, snap, mesh),
            "bytes": _per_rank(zero.state_bytes(state), mesh),
            "peak": _per_rank(peak, mesh), "kernels": list(kernels),
            "enc4": [list(state.model.state_dict()[w].shape),
                     list(state.optimizer.state[mu]["exp_avg"].shape)]}
        del state, step
    ref_batch = tstep.batch_to_device(batch, dev)
    ref_batch["weight"] = torch.ones(len(batch["mix"]), device=dev)
    ref_step = tstep.make_train_step(cfg)
    if time_reps and cuda:
        runs = {k: (*layout_state(k, cfg, mesh, seed), local)
                for k in layouts}
        runs["ref"] = (tstep.create_train_state(seed, cfg, device=dev),
                       ref_step, ref_batch)
        ref_ms = []
        for kind in ("ref", *layouts, *reversed(layouts), "ref"):
            if kind == "ref" and not mesh.is_primary:
                continue  # the others wait in the next layout's collectives
            state, step, inp = runs[kind]
            ms = _event_ms(lambda g: step(state, inp, g), dev, time_reps,
                           seed)
            if kind == "ref":
                ref_ms.append(ms)
            else:
                out[kind].setdefault("ms", []).append(_per_rank(ms, mesh))
        del runs
        for kind in layouts:
            out[kind]["ref_ms"] = ref_ms
    if not mesh.is_primary:
        return None
    ref_state, ref = ref_step(tstep.create_train_state(seed, cfg, device=dev),
                              ref_batch,
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


def sp_parity(mesh: mesh_lib.Mesh, model: torch.nn.Module, mag: np.ndarray
              ) -> Optional[Dict[str, float]]:
    """``separate_magnitude_mesh`` against ``separate_magnitude`` in both
    SP modes: the max |difference| of each, on rank 0 (None elsewhere)."""
    from svs_torch.infer import separate

    out = {}
    for mode in ("segments", "overlap"):
        got = separate.separate_magnitude_mesh(model, mag, mesh, mode=mode)
        if mesh.is_primary:
            want = separate.separate_magnitude(model, mag, mode=mode,
                                               device=mesh.device)
            out[mode] = float(np.abs(got - want).max())
    return out if mesh.is_primary else None


def sharded_layouts(n: int) -> tuple:
    """The layouts the dry run checks over ``n`` ranks: ZeRO-1 and FSDP
    where ``n > 1`` and ``128 % n == 0`` (``dryrun_multichip``'s guard:
    the channel rule must find channels to cut)."""
    return ("zero1", "fsdp") if n > 1 and 128 % n == 0 else ()


def dp_smoke_rank(mesh: mesh_lib.Mesh) -> Optional[Dict[str, object]]:
    """The dry run's checks on one rank (see the module's docstring);
    rank 0 returns their numbers."""
    cfg = SVSConfig(input_len=64, dropout_rate=0.5)
    step = layout_parity(mesh, cfg, dry_batch(mesh.size),
                         ("dp",) + sharded_layouts(mesh.size))
    model = tstep.create_train_state(0, cfg, device=mesh.device).model
    mag = np.abs(np.random.default_rng(3).standard_normal(
        (513, 150))).astype(np.float32)
    sp = sp_parity(mesh, model.eval(), mag)
    if not mesh.is_primary:
        return None
    return dict(step, sp=sp)


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
        ok = all(v <= SP_ATOL for v in sp.values())
        parts = []
        for kind, step in res.items():
            ok = ok and step["ok"] and step["spread"] == 0.0 \
                and step["shards_ok"]
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
                   f"{res['dp']['bytes'][0]:.0f}") + ")")
        skipped = [k for k in ("zero1", "fsdp") if k not in res]
        detail = (f"checked {list(CHECKED)}: " + "; ".join(parts)
                  + "; sp == unsharded decode (max "
                  + ", ".join(f"{k} {v:.2e}" for k, v in sp.items()) + ")"
                  + (f"; {skipped} skipped (needs devices > 1 dividing "
                     "128)" if skipped else "")
                  + f"; not ported: {list(NOT_PORTED)}")
    except Exception as e:  # the line reports the failure
        ok, detail = False, f"{type(e).__name__}: {str(e)[-2000:]}"
    return {"metric": "dp_smoke", "ok": bool(ok), "devices": devices,
            "wall_s": round(time.perf_counter() - t0, 1), "detail": detail}

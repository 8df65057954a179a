"""The port's multi-device dry run, ``bench_cli --dp-smoke`` (after
``__graft_entry__.dryrun_multichip`` and svs_tpu's ``bench_cli._dp_smoke``).

:func:`dp_smoke` starts ``devices`` gloo ranks on the CPU (a
:class:`~svs_torch.parallel.launch.Ranks` pool) and runs
:func:`dp_smoke_rank` on each, at the dry run's shapes (``input_len`` 64,
dropout 0.5, one patch a rank):

- one DP train step of a global batch, held on rank 0 against the
  unsharded step of the same batch, state and dropout generator
  (:func:`dp_parity`) under svs_tpu's envelope (:data:`ENVELOPE`), and
  every rank's state against rank 0's, bit for bit;
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
CHECKED = ("dp", "sp")
NOT_PORTED = ("zero1", "fsdp", "tp", "pp", "cp", "multihost")
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


def rank_spread(state: tstep.TrainState, mesh: mesh_lib.Mesh) -> float:
    """The largest |difference| between any rank's parameters and BN
    buffers and rank 0's (0.0: the same bits everywhere)."""
    flat = torch.cat([v.detach().reshape(-1).double() for v in
                      state.model.state_dict().values()])
    ref = flat.clone()
    if mesh_lib.crosses(mesh):
        dist.broadcast(ref, src=mesh.src, group=mesh.group)
    return _host_max(float((flat - ref).abs().max()), mesh)


def envelope(got: Dict[str, torch.Tensor], got_state: tstep.TrainState,
             want: Dict[str, torch.Tensor], want_state: tstep.TrainState,
             lr: float) -> Dict[str, object]:
    """One step's metrics and state against another's, under
    :data:`ENVELOPE`: the deltas and ``ok``."""
    total, ref_total = float(got["total"]), float(want["total"])
    gn, ref_gn = float(got["grad_norm"]), float(want["grad_norm"])
    a, b = got_state.model.state_dict(), want_state.model.state_dict()
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


def collective_probe(mesh: mesh_lib.Mesh) -> float:
    """One all-reduce of a 1 from every rank on the mesh's device: the
    rank count where the backend runs it."""
    t = torch.ones(1, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return float(t)


def dp_parity(mesh: mesh_lib.Mesh, cfg: SVSConfig,
              batch: Dict[str, np.ndarray], time_reps: int = 0
              ) -> Optional[Dict[str, object]]:
    """One DP step of the global host ``batch`` (the same on every rank)
    from the state of seed 0, against the unsharded step of the same batch
    (all-ones ``weight``), state and dropout generator on rank 0.  Returns
    on rank 0 the envelope's deltas, ``spread`` (:func:`rank_spread`
    after the step) and ``kernels``, the loss kernels' launches in the DP
    step (spectral_mag fwd / bwd, loss_partials fwd / bwd); None
    elsewhere.  ``time_reps`` > 0 on a CUDA mesh: then ``dp_ms`` and
    ``ref_ms``, each a pair of means of that many more DP and unsharded
    steps by CUDA events on rank 0, taken in turns (unsharded, DP, DP,
    unsharded)."""
    from svs_torch.ops.cuda import diff_mag as cdm
    from svs_torch.ops.cuda import fused_loss as cfl

    dev = mesh.device
    seed = 0
    state = dp.replicate_state(
        tstep.create_train_state(seed, cfg, device=dev), mesh)
    step = dp.make_dp_train_step(mesh, cfg)
    local = mesh_lib.shard_batch(mesh, batch)
    cdm.reset_counts()
    cfl.reset_counts()
    state, metrics = step(state, local,
                          torch.Generator(dev).manual_seed(seed + 1))
    kernels = _loss_kernel_counts()
    spread = rank_spread(state, mesh)
    out = None
    if mesh.is_primary:  # the others wait in the timing's first collective
        ref_state = tstep.create_train_state(seed, cfg, device=dev)
        ref_step = tstep.make_train_step(cfg)
        ref_batch = tstep.batch_to_device(batch, dev)
        ref_batch["weight"] = torch.ones(len(batch["mix"]), device=dev)
        ref_state, ref = ref_step(ref_state, ref_batch,
                                  torch.Generator(dev).manual_seed(seed + 1))
        out = envelope(metrics, state, ref, ref_state, cfg.learning_rate)
        out.update(spread=spread, kernels=list(kernels), dp_ms=[],
                   ref_ms=[])
    for kind in ("ref", "dp", "dp", "ref") if time_reps else ():
        if kind == "dp":  # every rank, in step
            ms = _event_ms(lambda g: step(state, local, g), dev, time_reps,
                           seed)
        elif mesh.is_primary:
            ms = _event_ms(lambda g: ref_step(ref_state, ref_batch, g), dev,
                           time_reps, seed)
        else:
            continue
        if out is not None:
            out[f"{kind}_ms"].append(ms)
    return out


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


def dp_smoke_rank(mesh: mesh_lib.Mesh) -> Optional[Dict[str, object]]:
    """The dry run's checks on one rank (see the module's docstring);
    rank 0 returns their numbers."""
    cfg = SVSConfig(input_len=64, dropout_rate=0.5)
    step = dp_parity(mesh, cfg, dry_batch(mesh.size))
    model = tstep.create_train_state(0, cfg, device=mesh.device).model
    mag = np.abs(np.random.default_rng(3).standard_normal(
        (513, 150))).astype(np.float32)
    sp = sp_parity(mesh, model.eval(), mag)
    if not mesh.is_primary:
        return None
    return {"dp": step, "sp": sp}


def dp_smoke(devices: int = 8, timeout: float = 1200.0) -> Dict[str, object]:
    """The dry run over ``devices`` gloo ranks on the CPU: svs_tpu's JSON
    line."""
    from svs_torch.parallel.launch import Ranks

    t0 = time.perf_counter()
    try:
        with Ranks(devices, device="cpu", backend="gloo",
                   timeout=timeout) as ranks:
            res = ranks.run(dp_smoke_rank)[0]
        step, sp = res["dp"], res["sp"]
        ok = (step["ok"] and step["spread"] == 0.0
              and all(v <= SP_ATOL for v in sp.values()))
        detail = (f"checked {list(CHECKED)}: dp == unsharded step (loss rel "
                  f"{step['loss_rel']:.2e}, grad_norm rel "
                  f"{step['grad_norm_rel']:.2e}, bn {step['bn_abs']:.2e}, "
                  f"params max {step['params_max']:.2e} mean "
                  f"{step['params_mean']:.2e}; rank spread "
                  f"{step['spread']:g}); sp == unsharded decode (max "
                  + ", ".join(f"{k} {v:.2e}" for k, v in sp.items())
                  + f"); not ported: {list(NOT_PORTED)}")
    except Exception as e:  # the line reports the failure
        ok, detail = False, f"{type(e).__name__}: {str(e)[-2000:]}"
    return {"metric": "dp_smoke", "ok": bool(ok), "devices": devices,
            "wall_s": round(time.perf_counter() - t0, 1), "detail": detail}

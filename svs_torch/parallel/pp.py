"""Two-stage pipeline parallelism (port of ``svs_tpu/parallel/pp.py``).

Split the U at encoder depth ``k = split`` (1..5):

- **stage 0** holds encoder levels ``1..k`` (``conv1..conv{k}``) and the
  mirror decoder levels ``7-k..6`` (``deconv{7-k}..deconv6``, the last one
  the BN-less final deconv) — every skip those decoder levels consume is
  made by stage 0's own encoder levels;
- **stage 1** holds the bottom of the U (``conv{k+1}..conv6`` and
  ``deconv1..deconv{6-k}``), whose skips are likewise its own.

No skip crosses the boundary.  The down-going ``conv{k}`` output and the
up-going ``deconv{6-k}`` output have the same shape ``(mb, ch[k], F/2^k,
T/2^k)`` (:func:`boundary_shape`).

**The schedule**: ``n_micro + 2`` ticks, three virtual stages on two
devices.  At tick t stage 0 runs the encoder front on microbatch t (A),
stage 1 the bottom on microbatch t-1 (B), and stage 0 the decoder tail and
the loss on microbatch t-2 (C).

**The mechanism is PyTorch's, the semantics svs_tpu's.**  svs_tpu runs one
SPMD program under ``shard_map``: a ``lax.scan`` of ticks whose traffic is
one ``ppermute`` swap, the stages' parameters packed into ``(2, L)`` flat
stacks so that both devices run the same program.  Here one process
drives both devices (svs_tpu's PP is single-process too, loop.py:321-324):

- the stage devices are a pair (:func:`make_pp_mesh`); each stage's
  levels, with their parameters, BatchNorm buffers and Adam's moments, live
  on its device (:func:`shard_state`), and the state stays the ordinary
  :class:`~svs_torch.train.step.TrainState` (no flat packing: svs_tpu's
  ``_Packer`` exists for SPMD uniformity only);
- a boundary tensor crosses with ``.to(other, non_blocking=True)``, which
  autograd differentiates.  A copy between two cards orders both cards'
  current streams (a two-way barrier at the point it is enqueued), so
  every copy of a tick (the two boundary tensors and stage 1's Dropout2d
  masks of the microbatch entering it) is enqueued at the tick's end,
  after A, B and C: within a tick stage 0's A and C can then run beside
  stage 1's B, and the tick's end is the barrier that svs_tpu's
  ``ppermute`` is.  That the forward overlaps on two cards is not yet
  measured (ROADMAP A.10.5);
- the backward is autograd through the tick loop, as svs_tpu's is
  ``jax.grad`` through the scan; its order across the two cards is
  autograd's engine's (one thread per device), not the tick schedule;
- ticks with no real microbatch, and microbatches whose ``weight`` is all
  zero, are skipped in Python, from the live pattern read on the host
  before the step (:func:`live_pattern`).  svs_tpu runs them on clamped
  data and gates their contributions to nothing; skipping is the exact
  equivalent.
  A microbatch's tensors are its own (no two-slot ring), so nothing aliases
  when both stages are one device and ``.to()`` is a no-op.

**Semantics against the single-device step**:

- ``n_micro = 1`` is ``make_train_step``'s arithmetic in its order (the
  same levels on the same inputs, the dropout masks drawn from the step's
  generator in ``UNet.forward``'s order, on the generator's device: stage
  1's at the end of the microbatch's A tick, stage 0's in its C tick), so
  on one device it gives that step's bits;
- ``n_micro > 1`` is GPipe's: BatchNorm takes each microbatch's statistics
  and the running statistics see the microbatches in order; the loss, the
  metrics and so the gradient are the mean over the live microbatches; and
  microbatch m draws its Dropout2d masks from a generator of its own
  (:func:`microbatch_generators`, svs_tpu's ``fold_in(rng, m)``).

**Programs.**  svs_tpu jits the PP train and eval steps
(svs_tpu pp.py:570-645).  Here, where both stages are one CUDA device
(:func:`programmed`), each step is the cached captured program of its key
(``train/graphs.py``, layout ``"pp"`` over the pair of stage devices, with
``n_micro``, ``split`` and the live pattern in the key), over its eager
body, which stays the oracle (``step.eager``).  Two distinct cards run
the eager step by that rule, decided before any step: one process
capturing over two devices' allocators and streams is a design of its own
(ROADMAP A.10.8).

``grad_norm`` is the global norm of both stages' gradients, each square
summed on its stage and the sum taken on stage 0's device.  PP does not
compose with gradient accumulation (``accum_steps > 1``): microbatching
already accumulates.  A checkpoint is written from :func:`gather_state`,
the whole state copied onto one device, as the canonical ``.ckpt``.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from svs_torch.losses.mrstft import combined_loss
from svs_torch.models.unet import UNet
from svs_torch.train import graphs
from svs_torch.train.step import TrainState, _apply
from svs_torch.utils.config import SVSConfig
from svs_torch.utils.device import DeviceLike, resolve_device

Stages = Tuple[torch.device, torch.device]


def make_pp_mesh(devices: Optional[Sequence[DeviceLike]] = None) -> Stages:
    """The two stage devices.  ``None``: ``cuda:0`` and ``cuda:1``, which
    raises with fewer than two cards (no fallback to the host) and says so
    where more stay idle.  The tests pass ``("cpu", "cpu")``, and one card
    may hold both stages (``("cuda:0", "cuda:0")``)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < 2:
            raise ValueError(f"pipeline needs 2 devices, have {n}")
        if n > 2:
            print(f"[svs-torch] pipeline uses 2 of {n} devices; the other "
                  f"{n - 2} stay idle — use DP (--dp) or TP (--tp) to "
                  "engage them")
        devices = ("cuda:0", "cuda:1")
    return stage_devices(devices)


def stage_devices(mesh) -> Stages:
    """``mesh`` as the pair of stage devices, each CUDA device with its
    index; raises unless it names two devices."""
    devs = list(mesh) if isinstance(mesh, (tuple, list)) else []
    if len(devs) != 2:
        raise ValueError("parallel='pp' needs a pair of stage devices "
                         f"(pp.make_pp_mesh), not {mesh!r}")
    out = []
    for d in devs:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    return tuple(out)


# ------------------------------------------------------- the stage split


def stage_levels(split: int):
    """The levels of each stage, by module index (svs_tpu's
    ``_stage_arch``): ``((enc of stage 0, dec of stage 0), (enc of stage 1,
    dec of stage 1))``, ``conv{i}`` and ``deconv{i}``."""
    k = split
    if not 1 <= k <= 5:
        raise ValueError(f"split must be in 1..5, got {k}")
    return ((range(1, k + 1), range(7 - k, 7)),
            (range(k + 1, 7), range(1, 7 - k)))


_LEVEL = re.compile(r"(de)?conv(\d)")


def stage_of(name: str, split: int) -> int:
    """The stage (0 or 1) that holds level ``name`` of a split at ``split``:
    a module (``conv3``, ``deconv4_BAD``) or state-dict name
    (``conv3.1.running_mean``).  svs_tpu's ``split_params`` /
    ``join_params`` as a rule: stage 0 holds ``conv1..conv{k}`` and
    ``deconv{7-k}..deconv6``."""
    (enc0, dec0), _ = stage_levels(split)
    m = _LEVEL.match(name)
    if m is None:
        raise ValueError(f"{name!r} is no level of the U-Net")
    i = int(m.group(2))
    return 0 if i in (dec0 if m.group(1) else enc0) else 1


def boundary_shape(cfg: SVSConfig, split: int, mb: int, n_frames: int
                   ) -> Tuple[int, int, int, int]:
    """The NCHW shape of both boundary tensors of a microbatch of ``mb``
    rows: ``(mb, ch[k], F / 2^k, T / 2^k)``."""
    chans = (1,) + tuple(cfg.enc_channels)
    return (mb, chans[split], cfg.freq_bins // 2 ** split,
            n_frames // 2 ** split)


# -------------------------------------------------------------- the state


@dataclasses.dataclass
class PPState(TrainState):
    """A :class:`TrainState` whose levels live on their stages' devices:
    the model, its Adam and their tensors are the ordinary ones, placed by
    :func:`stage_of` at ``split``."""
    devices: Optional[Stages] = None
    split: int = 3


def _on_device(v, p: torch.Tensor, dev: torch.device):
    """An optimizer-state entry of parameter ``p`` on ``dev`` (copied): the
    tensors shaped as ``p`` and a capturable Adam's device-side step
    count; the rest as it is (a host step count cloned)."""
    if not isinstance(v, torch.Tensor):
        return v
    if v.shape == p.shape or v.device.type != "cpu":
        return v.detach().to(dev, copy=True)
    return v.clone()


def shard_state(state: TrainState, mesh, *, split: int = 3) -> PPState:
    """``state`` with each level moved to its stage's device (in place: the
    module and its Adam are shared with ``state``), Adam's moments with
    their parameters.  Refuses accumulation (svs_tpu's ``_check_opt``)."""
    devs = stage_devices(mesh)
    stage_levels(split)
    if state.accum_steps > 1 or state.acc_grads is not None:
        raise ValueError(
            "pipeline parallelism does not compose with accum_steps > 1 "
            "(MultiSteps): PP microbatching already accumulates; use "
            "n_micro instead")
    model = state.model
    with torch.no_grad():
        for name, module in model.named_children():
            module.to(devs[stage_of(name, split)])
        opt = state.optimizer
        for p in model.parameters():
            if opt.state.get(p):
                opt.state[p] = {k: _on_device(v, p, p.device)
                                for k, v in opt.state[p].items()}
    return PPState(model, state.optimizer, step=state.step,
                   accum_steps=state.accum_steps, mini_step=state.mini_step,
                   devices=devs, split=split)


def gather_state(state: PPState) -> TrainState:
    """The whole state copied onto stage 0's device as a plain
    :class:`TrainState`: the model, Adam with its hyperparameters and
    moments, the step count.  The canonical checkpoint is written from it;
    ``state`` goes on training."""
    dev = state.devices[0]
    model = copy.deepcopy(state.model).to(dev)
    old = state.optimizer
    opt = type(old)(list(model.parameters()), **old.defaults)
    opt.param_groups[0].update({k: v for k, v in old.param_groups[0].items()
                                if k != "params"})
    for p, q in zip(state.model.parameters(), model.parameters()):
        if old.state.get(p):
            opt.state[q] = {k: _on_device(v, p, dev)
                            for k, v in old.state[p].items()}
    return TrainState(model, opt, step=state.step,
                      accum_steps=state.accum_steps,
                      mini_step=state.mini_step)


def stage_bytes(state: TrainState) -> List[int]:
    """The bytes each stage device holds between steps (as placed by
    :func:`shard_state`): the parameters, the BatchNorm buffers and the
    optimizer's tensors of its levels."""
    out = [0, 0]
    params = dict(state.model.named_parameters())
    opt = state.optimizer.state
    for name, t in state.model.state_dict(keep_vars=True).items():
        held = [t] + [v for v in (opt.get(params[name], {}) if name in params
                                  else {}).values()
                      if isinstance(v, torch.Tensor) and v.device == t.device]
        out[stage_of(name, state.split)] += sum(
            v.nelement() * v.element_size() for v in held)
    return out


def _check_state(state: TrainState, devs: Stages, split: int) -> None:
    if not isinstance(state, PPState):
        raise TypeError("the pipelined step takes a PPState "
                        "(pp.shard_state)")
    if state.split != split or state.devices != devs:
        raise ValueError(
            f"the state's stages were cut at split={state.split} on "
            f"{state.devices}, but this step expects split={split} on "
            f"{devs} — stages were cut at a different point than the "
            "step expects")


# ---------------------------------------------------------- the batch


def pad_batch(batch: Dict, batch_size: int) -> Dict:
    """The drop-free tail padder of the pipelined step (svs_tpu's
    ``pp.pad_batch``): rows padded to the fixed ``batch_size`` with a 0/1
    ``weight``, as ``mesh.shard_batch`` pads.  Padding may swallow whole
    microbatches, which the step skips.  A full batch without a
    ``weight`` passes through untouched.  Numpy arrays or tensors."""
    rows = len(next(iter(batch.values())))
    if rows > batch_size:
        raise ValueError(f"batch has {rows} rows > batch_size {batch_size}")
    if rows == batch_size and "weight" not in batch:
        return batch
    pad = batch_size - rows

    def padded(v):
        if isinstance(v, torch.Tensor):
            return (torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
                    if pad else v)
        v = np.asarray(v)
        return (np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                if pad else v)

    out = {k: padded(v) for k, v in batch.items() if k != "weight"}
    w = batch.get("weight")
    if w is None:
        like = batch["mix"]
        w = (torch.ones(rows, device=like.device)
             if isinstance(like, torch.Tensor) else np.ones(rows, np.float32))
    elif not isinstance(w, torch.Tensor):
        w = np.asarray(w, np.float32)
    out["weight"] = padded(w)
    return out


def live_pattern(batch: Dict, n_micro: int) -> Tuple[bool, ...]:
    """Whether each of the batch's ``n_micro`` contiguous microbatches holds
    a real row, read from its ``weight`` on the host (a device weight is
    copied back: ``fit``'s batches are host arrays); raises where ``n_micro``
    does not divide the rows or no row is live."""
    rows = len(batch["mix"])
    if n_micro < 1 or rows % n_micro:
        raise ValueError(f"n_micro={n_micro} must divide the batch's "
                         f"{rows} rows")
    mb = rows // n_micro
    w = batch.get("weight")
    if w is None:
        return (True,) * n_micro
    host = (w.detach().cpu().numpy() if isinstance(w, torch.Tensor)
            else np.asarray(w))
    live = tuple(bool(host[m * mb:(m + 1) * mb].sum() > 0)
                 for m in range(n_micro))
    if not any(live):
        raise ValueError("a batch with no live row (all weight 0)")
    return live


def _microbatches(batch: Dict, n_micro: int, dev: torch.device):
    """The batch on ``dev`` cut into ``n_micro`` contiguous microbatches."""
    mb = len(batch["mix"]) // n_micro
    full = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
            for k, v in batch.items()}
    return [{k: v[m * mb:(m + 1) * mb] for k, v in full.items()}
            for m in range(n_micro)]


def as_batch(batch: Dict) -> Dict[str, torch.Tensor]:
    """A host or device batch as float32 tensors where they lie (a numpy
    array shared, not copied): what a step program copies in."""
    return {k: torch.as_tensor(v, dtype=torch.float32)
            for k, v in batch.items()}


def microbatch_seeds(generator: torch.Generator, n_micro: int) -> List[int]:
    """The seeds of a step's microbatch generators (svs_tpu's ``fold_in(rng,
    m)``): the top 63 bits of the 8-byte BLAKE2b digest of
    ``generator.get_state()``'s bytes followed by m as 8 little-endian
    bytes.  ``get_state`` reads the seed and offset on the host, so this
    does not wait on the card."""
    state = generator.get_state().numpy().tobytes()
    return [int.from_bytes(hashlib.blake2b(
        state + m.to_bytes(8, "little"), digest_size=8).digest(),
        "little") >> 1 for m in range(n_micro)]


def advance(generator: torch.Generator) -> None:
    """Move ``generator`` on by one draw, on its device, so that the next
    step derives other seeds (inside a step program's graph, which
    registers it)."""
    torch.empty(1, device=generator.device).bernoulli_(0.5,
                                                       generator=generator)


def microbatch_generators(generator: Optional[torch.Generator],
                          n_micro: int) -> list:
    """Dropout's random source for each microbatch of a step.

    ``n_micro = 1``: the step's ``generator`` itself, so that the masks are
    ``make_train_step``'s.  ``n_micro > 1``: microbatch m's generator is a
    new one on ``generator``'s device seeded with
    :func:`microbatch_seeds`' m-th seed; then ``generator`` advances by
    one draw (:func:`advance`).  Without a generator each microbatch draws
    from the device's default one.  The step programs keep persistent
    generators instead, re-seeded alike before every call
    (:func:`make_pp_train_step`)."""
    if n_micro == 1 or generator is None:
        return [generator] * n_micro
    out = [torch.Generator(generator.device).manual_seed(s)
           for s in microbatch_seeds(generator, n_micro)]
    advance(generator)
    return out


def programmed(mesh) -> bool:
    """Whether PP's steps over the stage devices of ``mesh`` run as cached
    programs, decided before any step (``graphs.stages_programmed``): where
    both stages are one CUDA device.  Two distinct cards run the eager
    step by that rule; their capture is parked (ROADMAP A.10.8)."""
    return graphs.stages_programmed(stage_devices(mesh))


# ------------------------------------------------------- the pipeline


def make_pp_pipeline(mesh, cfg: Optional[SVSConfig] = None, *,
                     n_micro: int = 4, split: int = 3):
    """The pipelined forward and loss:
    ``fn(model, batch, generator, live=None, gens=None) -> (loss,
    metrics)``.

    ``batch``: the whole batch (numpy arrays or tensors, an optional (B,)
    0/1 ``weight``), B divisible by ``n_micro``.  ``live``: the microbatches
    that hold a real row (:func:`live_pattern`, read from the weight
    unless given); ``gens``: each microbatch's dropout generator
    (:func:`microbatch_generators` of ``generator`` unless given).  Given
    both, the pipeline reads nothing on the host: what a step program
    captures.  In train mode the loss is
    the differentiable mean over the live microbatches, on stage 0's
    device, and the BatchNorm running statistics are written microbatch by
    microbatch; ``metrics`` (``l1``, ``mr``, ``total``) are the detached
    means.  In eval mode (``model.eval()``, under ``torch.no_grad``) the
    same ticks run with the running statistics and no dropout."""
    cfg = cfg or SVSConfig()
    devs = stage_devices(mesh)
    (enc0, dec0), (enc1, dec1) = stage_levels(split)
    d0, d1 = devs

    def pipeline(model: UNet, batch: Dict,
                 generator: Optional[torch.Generator] = None, *,
                 live: Optional[Sequence[bool]] = None,
                 gens: Optional[Sequence] = None):
        if live is None:
            live = live_pattern(batch, n_micro)
        if gens is None:
            gens = microbatch_generators(generator, n_micro)
        mbs = _microbatches(batch, n_micro, d0)
        w1 = [None if mb.get("weight") is None
              else mb["weight"].to(d1, non_blocking=True) for mb in mbs]
        down: Dict[int, torch.Tensor] = {}   # boundary, stage 0 -> 1
        up: Dict[int, torch.Tensor] = {}     # boundary, stage 1 -> 0
        keeps: Dict[int, Dict] = {}          # stage 1's dropout masks
        skips: Dict[int, List[torch.Tensor]] = {}
        totals, aux = [], []
        for t in range(n_micro + 2):
            a_out = b_out = None
            m = t  # A: stage 0's encoder front on microbatch t
            if m < n_micro and live[m]:
                x = mbs[m]["mix"].to(torch.float32)[:, None]
                skips[m] = []
                for i in enc0:
                    x = model.encode(i, x, mbs[m].get("weight"))
                    skips[m].append(x)
                a_out = x
            m = t - 1  # B: stage 1, the bottom of the U, on microbatch t-1
            if 0 <= m < n_micro and live[m]:
                x, keep = down.pop(m), keeps.pop(m)
                bottom = {}
                for i in enc1:
                    x = model.encode(i, x, w1[m])
                    bottom[i] = x
                for i in dec1:
                    inp = (bottom[6] if i == 1
                           else torch.cat([x, bottom[7 - i]], dim=1))
                    x = model.decode(i, inp, w1[m], keep[i])
                b_out = x
            m = t - 2  # C: stage 0's decoder tail and the loss, t-2
            if 0 <= m < n_micro and live[m]:
                x, own, mb = up.pop(m), skips.pop(m), mbs[m]
                for i in dec0:
                    inp = torch.cat([x, own[6 - i]], dim=1)
                    if i == 6:
                        x = model.final_dec(inp)
                    else:
                        x = model.decode(i, inp, mb.get("weight"),
                                         model.dec_keep(i, inp, gens[m]))
                mask = torch.sigmoid(x.to(torch.float32))[:, 0]
                total, parts = combined_loss(
                    mask, mb["mix"], mb["voc"], mb["mix_angle"],
                    mb["voc_angle"], cfg, weight=mb.get("weight"))
                totals.append(total)
                aux.append(parts)
            # the tick's copies, after its work on both devices: microbatch
            # t's masks for stage 1 (drawn on stage 0's side: only the rows
            # and device of a_out are read) go over with its boundary
            if a_out is not None:
                keep = {i: model.dec_keep(i, a_out, gens[t]) for i in dec1}
                keeps[t] = {i: None if k is None
                            else k.to(d1, non_blocking=True)
                            for i, k in keep.items()}
                down[t] = a_out.to(d1, non_blocking=True)
            if b_out is not None:
                up[t - 1] = b_out.to(d0, non_blocking=True)
        n = len(totals)
        metrics = {k: (sum(a[k] for a in aux) / n).detach() for k in aux[0]}
        return sum(totals) / n, metrics

    return pipeline


def _pp_body(cfg: SVSConfig, devs: Stages, n_micro: int, split: int):
    """The PP step without its count: ``body(state, batch, generator, part,
    gens) -> metrics`` (the pipeline's loss, its gradient by autograd
    through the ticks, ``grad_norm`` over both stages, the optimiser
    call); with microbatch generators, ``generator``'s one-draw advance.
    ``part``: :func:`make_pp_train_step`'s key part, whose third entry is
    the live pattern; ``gens``: the microbatch generators, seeded by
    :func:`microbatch_seeds`, or none where they are ``generator`` itself
    or the default one (one microbatch, or no generator).  What a PP train
    program captures."""
    pipeline = make_pp_pipeline(devs, cfg, n_micro=n_micro, split=split)

    def body(state: PPState, batch: Dict,
             generator: Optional[torch.Generator], part: tuple,
             gens: Sequence[torch.Generator]) -> Dict[str, torch.Tensor]:
        model = state.model.train()
        params = list(model.parameters())
        loss, metrics = pipeline(model, batch, generator, live=part[2],
                                 gens=gens or None)
        if gens:
            advance(generator)
        grads = torch.autograd.grad(loss, params)
        metrics["grad_norm"] = torch.sqrt(sum(
            torch.sum(torch.square(g)).to(devs[0]) for g in grads))
        _apply(state, list(grads))
        return metrics

    return body


def make_pp_train_step(mesh, cfg: Optional[SVSConfig] = None, *,
                       n_micro: int = 4, split: int = 3):
    """The pipelined ``step(state, batch, generator) -> (state, metrics)``
    on a :class:`PPState` of the same ``mesh`` and ``split``
    (:func:`shard_state`): the pipeline's loss, its gradient by autograd
    through the ticks, ``grad_norm`` over both stages, one optimizer
    update in place.

    Where :func:`programmed` (both stages one CUDA device) the step is the
    cached program of its key (``train/graphs.py``, layout ``"pp"`` over
    the pair of stage devices), else eager; ``step.eager`` is the eager
    form.  Before either form runs, the host reads the batch's live
    microbatches (:func:`live_pattern`, which refuses a batch with none),
    which join the program's key with ``n_micro`` and ``split``: a full
    batch and a ragged tail have programs of their own.  At ``n_micro >
    1`` with a generator the step's microbatch seeds
    (:func:`microbatch_seeds`, read on the host) seed new generators in the
    eager form and, in a program, the program's own ``n_micro`` generators
    (registered with its graphs) before every call, so that a replay draws
    the masks of :func:`microbatch_generators`' fresh ones.  The step holds
    no state of its own: two steps over one model share their programs."""
    cfg = cfg or SVSConfig()
    devs = stage_devices(mesh)
    body = _pp_body(cfg, devs, n_micro, split)

    def prepare(state, batch, generator):
        live = live_pattern(batch, n_micro)
        seeds = (microbatch_seeds(generator, n_micro)
                 if n_micro > 1 and generator is not None else [])
        return (n_micro, split, live, bool(seeds)), seeds

    step = graphs.train_step(cfg, body, "pp", devs,
                             lambda state: _check_state(state, devs, split),
                             prepare)

    def pp_step(state: PPState, batch: Dict,
                generator: Optional[torch.Generator] = None):
        return step(state, as_batch(batch), generator)

    def eager(state: PPState, batch: Dict,
              generator: Optional[torch.Generator] = None):
        return step.eager(state, as_batch(batch), generator)

    pp_step.eager = eager
    return pp_step


def make_pp_eval_step(mesh, cfg: Optional[SVSConfig] = None, *,
                      split: int = 3):
    """Validation on a :class:`PPState` (``make_eval_step``'s semantics):
    the whole batch through both stages in eval mode, no dropout; returns
    the metrics.  The cached eval program of its key where
    :func:`make_pp_train_step` is a program (``step.eager`` the eager
    form); a batch with no live row is refused before either runs."""
    cfg = cfg or SVSConfig()
    devs = stage_devices(mesh)
    pipeline = make_pp_pipeline(devs, cfg, n_micro=1, split=split)

    def body(model: UNet, batch: Dict) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            return pipeline(model, batch, live=(True,), gens=(None,))[1]
        finally:
            model.train(was_training)

    def prepare(state, batch):
        live_pattern(batch, 1)
        return (split,)

    step = graphs.eval_step(cfg, body, "pp", devs,
                            lambda state: _check_state(state, devs, split),
                            prepare)

    def pp_step(state: PPState, batch: Dict) -> Dict[str, torch.Tensor]:
        return step(state, as_batch(batch))

    def eager(state: PPState, batch: Dict) -> Dict[str, torch.Tensor]:
        return step.eager(state, as_batch(batch))

    pp_step.eager = eager
    return pp_step

"""The train and eval steps' compiled programs: cached, captured CUDA graphs
(the counterpart of svs_tpu's ``make_train_step``, ``jax.jit`` of the whole
step with the state donated, and its jitted ``make_eval_step``, svs_tpu
train/step.py:148-177).

svs_tpu compiles the step once per static signature and runs the compiled
program after that: the forward, the loss, the backward and the optimiser
update with no host round trip.  Here a :class:`TrainProgram` is that
program on the card: the eager step (``step.make_step_fn``'s body, which
stays a plain function and the tests' oracle) captured into one
``torch.cuda.CUDAGraph`` per accumulation position over static batch
buffers, replayed for every later call of its key.  The eval step's
program is the decode's :class:`infer.graphs.Program` over a batch
(:func:`eval_program`).

- **Key.** One program per (kind, layout, mesh, model, step config,
  batch signature, ``accum_steps``, device, the caller's part): the layout
  is the step's name (``single``, ``dp``, ``zero1``, ``fsdp``, ``tp``,
  ``cp``, ``pp``) and the mesh its ``parallel.mesh.Mesh`` (a ``Mesh2D`` for
  TP; the program's body holds it, so its ``id`` is not reused while the
  program is cached) or PP's pair of stage devices (by value), so a
  layout's step never replays the single step's body, nor the same
  layout's on another mesh; the signature is the batch's keys (with or
  without ``weight``), shapes and dtypes, so a ragged tail batch or a
  padded one has a program of its own.  The caller's part is what its
  step decides on the host before a call (``prepare``; the body is given
  it): PP's microbatch count, split, live-microbatch pattern and whether
  its microbatches draw from generators of their own.  Beside the key a
  program holds its
  *binding* (:func:`binding`): the address of every ``state_dict()``
  tensor, of every Adam state tensor and of the accumulation buffers,
  Adam's constants (lr, betas, eps, weight decay; the graph bakes them in)
  and the TF32 and cuDNN flags.  A changed binding (the learning-rate drop,
  a checkpoint restore, ``model.to(...)``) or another dropout generator
  drops the graphs and captures them again.
- **Build.** A train step mutates the state, so no call is thrown away: the
  first call of a program runs the eager step as the *real* step on a side
  stream (PyTorch's recipe), and so does every call until Adam has its
  state (``accum_steps`` microbatches); they build the kernels, put the
  loss kernels' bases on the card and give Adam its moments, so no build,
  host copy or allocation of optimiser state is captured.  The next call
  captures (a capture runs nothing) and replays.  N calls leave the state
  of N eager steps.  The eval body has no side effect: its program runs it
  ``infer.graphs.WARMUP_CALLS`` times and captures when it is built, as
  the decode's programs do, and is built again when the model's binding
  moved.
- **Calls.** A call copies the batch into the static buffers on the
  caller's stream, replays, moves the host's ``state.step``,
  ``mini_step`` and ``acc_grads`` on as the replayed ``_apply`` did, and
  returns *copies* of the metrics: a result never aliases a buffer that the
  next replay writes.  Dropout's ``torch.Generator`` is registered with
  every graph, so each replay draws the masks the eager step would; so are
  the program's own generators beside it, one a seed that the caller's
  ``prepare`` returns (PP's microbatch generators), re-seeded on the host
  before every call.
- **Adam.** A graph replays only torch's capturable Adam (its step counts
  on the card, the bias corrections there in float32, as optax keeps
  them): a host-form Adam reaching a program on the card raises.
- **Memory.** A step program's pool keeps the step's activations, so the
  cache holds at most :data:`MAX_BYTES`, least recently used dropped first
  (``infer.graphs.ProgramCache``).

A capture that fails raises; nothing on the card falls back to the eager
body.  On the CPU a program captures nothing: a call copies into its static
buffers, keeps the key and the binding as on the card (a train program's
``captures`` counts the bindings it took), runs the body and returns
copies.
``step.make_train_step`` and ``step.make_eval_step`` take programs on the
card only (:func:`programmed`; the CPU tests patch it).

**Layouts.** The steps ``fit`` builds for a mesh (``parallel/dp.py``,
``zero.py``, ``tp.py``, ``halo.py``) are made by :func:`train_step` and
:func:`eval_step` too, from the layout's eager body, so each runs as the
cached program of its key where :func:`mesh_programmed` says so, decided
before any step: on a CUDA device (the single steps' rule), except gloo
across ranks there (ranks that share one card, which NCCL refuses), whose
collectives run on the host where no graph can hold them; those ranks run
the eager bodies by that rule, not as a fallback (``scan.refuse_mesh``
refuses them under ``epoch_scan`` by the same test,
``mesh.host_collectives``).  PP's steps (``parallel/pp.py``) take their own
rule, :func:`stages_programmed`: programs where both stages are one device
on which the steps are programs; two distinct cards (one process over two
devices' allocators and streams) run the eager step.  NCCL's collectives are
captured with the step, as the mesh ``epoch_scan``'s graphs capture them; a
capture that fails there raises.  Every step these makers return carries its
eager form as ``step.eager``: the oracle the programs are held against.

The capture rules (:func:`binding`, :func:`warm_up`, :func:`capture`,
:func:`replay`) are shared with ``train/scan.py``'s epoch graphs.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from svs_torch.infer import graphs as infer_graphs
from svs_torch.parallel import mesh as mesh_lib
from svs_torch.train.step import TrainState, _accumulator
from svs_torch.utils import profiling

# The bound on the bytes all cached step programs hold.  A train program of
# the ``default`` preset at B = 32 holds its pool of the step's activations
# and its static batch: 0.82 / 1.58 / 2.35 GB under ``pallas_fused`` /
# ``pallas_bf16`` / ``matmul_bf16``'s PyTorch composition (which the card
# now runs only where the loss kernels do not serve; on them
# ``matmul_bf16`` holds what ``pallas_fused`` holds), 0.52 / 1.00 / 1.44 GB
# at a tail of 20 rows; with validation's two programs (0.13-1.16 GB each)
# a ``fit`` holds 1.68 / 3.89 / 5.69 GB (H100, ``chip_smoke.py``'s step
# graph phase).  8 GiB keeps a ``fit``'s four programs under every loss path and
# leaves 89 % of an 80-GB card to the run.
MAX_BYTES = 8 << 30

Metrics = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]
# a train body: the step without its count (``_apply`` moves the cycle on);
# an eval body: the metrics of a batch
TrainBody = Callable[[TrainState, Batch, Optional[torch.Generator]], Metrics]
EvalBody = Callable[[torch.nn.Module, Batch], Metrics]


def programmed(dev: torch.device) -> bool:
    """Whether the steps on ``dev`` run as cached programs: on the card
    they always do; on the CPU, which a caller asks for explicitly, they
    run eagerly (the CPU tests patch this to route the host through the
    programs)."""
    return dev.type == "cuda"


def stages_programmed(devs) -> bool:
    """Whether PP's steps over the stage devices ``devs`` run as cached
    programs: where both stages are one device on which the steps are
    programs (:func:`programmed`).  Two distinct devices run the eager
    step: a capture over two devices' allocators and streams from one
    process is a design of its own (ROADMAP A.10.8)."""
    return devs[0] == devs[1] and programmed(devs[0])


def mesh_programmed(mesh: mesh_lib.Mesh) -> bool:
    """Whether a layout's steps over ``mesh`` run as cached programs: as
    the single steps on its device (:func:`programmed`), except where its
    collectives run on the host (``mesh.host_collectives``: gloo across
    ranks on a CUDA device), which no graph can hold; those ranks run the
    eager bodies."""
    return programmed(mesh.device) and not mesh_lib.host_collectives(mesh)


# ------------------------------------------------- the shared capture rules

def binding(state: TrainState, static=()) -> tuple:
    """What a captured step reads by address or bakes in: the model's
    (``infer.graphs.binding``: every ``state_dict()`` address, the dtype,
    the TF32 and cuDNN flags), every Adam state tensor's and the
    accumulation buffers' addresses, ``static`` tensors' (an epoch graph's
    planes and buffers), and the optimiser's constants (every entry of its
    parameter groups but the parameters: Adam's lr, betas, eps, weight
    decay and flags; another optimiser's own)."""
    opt = state.optimizer
    ptrs = [t.data_ptr() for st in opt.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)]
    ptrs += [t.data_ptr() for t in state.acc_buffers or ()]
    ptrs += [t.data_ptr() for t in static if t is not None]
    consts = tuple(tuple((k, tuple(v) if isinstance(v, list) else v)
                         for k, v in sorted(g.items()) if k != "params")
                   for g in opt.param_groups)
    return infer_graphs.binding(state.model), tuple(ptrs), consts


def adopt_cycle(state: TrainState) -> None:
    """An accumulation cycle loaded from a checkpoint into the state's
    ``acc_buffers``, which a graph reads by address: before the binding is
    taken."""
    if state.acc_grads is not None:
        _accumulator(state, state.acc_grads)


def require_capturable(state: TrainState, what: str) -> None:
    if not all(g["capturable"] for g in state.optimizer.param_groups):
        raise ValueError(f"{what} on a CUDA device needs the state's Adam in "
                         "its capturable form (step.make_optimizer's "
                         "default on a CUDA device)")


def adam_ready(state: TrainState) -> bool:
    """Whether Adam holds its state for every parameter (a capture must
    not allocate it)."""
    return len(state.optimizer.state) >= len(
        state.optimizer.param_groups[0]["params"])


def warm_up(state: TrainState, run: Callable[[], Metrics], n: int,
            device: torch.device) -> Tuple[int, Metrics]:
    """Eager steps (``run``, then the step count) until Adam has its state,
    at least one and at most ``n``: real steps of the run, on a side stream
    of a CUDA device.  Returns how many ran and the last one's metrics."""
    cuda = device.type == "cuda"
    if cuda:
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
    done, metrics = 0, {}
    with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
        while done < n and (done == 0 or not adam_ready(state)):
            metrics = run()
            state.step += 1
            done += 1
    if cuda:
        torch.cuda.current_stream(device).wait_stream(side)
    return done, metrics


def capture(state: TrainState, run: Callable[[], Metrics],
            generators, device: torch.device
            ) -> Tuple[Dict[int, Tuple[torch.cuda.CUDAGraph, Metrics]], int]:
    """One graph of ``run`` per accumulation position, in one memory pool,
    each registering ``generators`` (a generator, or a sequence of them;
    None for none); a capture runs nothing, so the host's
    cycle position is put back after it.  Returns the graphs with their
    static outputs, and the bytes their pool took
    (``infer.graphs.pool_bytes``)."""
    graphs = {}
    if generators is None or isinstance(generators, torch.Generator):
        generators = (generators,)

    def record():
        position, acc = state.mini_step, state.acc_grads
        pool = None
        try:
            for k in range(state.accum_steps):
                graph = torch.cuda.CUDAGraph()
                for generator in generators:
                    if generator is not None:
                        graph.register_generator_state(generator)
                state.mini_step = k
                state.acc_grads = state.acc_buffers if k else None
                with torch.cuda.graph(graph, pool=pool):
                    out = run()
                pool = graph.pool()
                graphs[k] = (graph, out)
        finally:
            state.mini_step, state.acc_grads = position, acc

    return graphs, infer_graphs.pool_bytes(record, device)


def replay(state: TrainState, graphs) -> Metrics:
    """One step as the replay of the graph at the state's cycle position;
    moves the host's step count and cycle position on as the replayed
    ``_apply`` did.  Returns that graph's static outputs."""
    k = state.mini_step
    graph, out = graphs[k]
    with profiling.annotate("svs.train.replay"):
        graph.replay()
    state.step += 1
    state.mini_step = (k + 1) % state.accum_steps
    state.acc_grads = state.acc_buffers if state.mini_step else None
    return out


# ------------------------------------------------------------ the programs

def signature(batch: Batch) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(
        batch.items()))


class TrainProgram:
    """One train step program: ``body`` over static buffers shaped as
    ``batch``.  On a CUDA device its graphs are captured after its eager
    warm-up and replayed; on the CPU the same calls run the body where a
    capture and a replay would be (the key, the binding and the copies
    run there too)."""

    def __init__(self, model, body: TrainBody, batch: Batch,
                 device: torch.device, part=None):
        self.model = weakref.ref(model)
        self.body = body
        self.part = part  # the key's caller part; None: a plain body
        self.device = device
        self.input = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                      for k, v in batch.items()}
        self.static_bytes = sum(v.nbytes for v in self.input.values())
        self.pool_bytes = 0
        self.graphs: Optional[dict] = None
        self.binding = None
        self.generators: Tuple[Optional[torch.Generator], ...] = ()
        self.own: Optional[list] = None  # the generators the seeds seed
        self.warm = False  # whether a call ran the eager warm-up step
        self.captures = 0  # times the graphs were captured
        self.replays = 0   # calls that ran as replays
        self._done: Optional[torch.cuda.Event] = None

    @property
    def nbytes(self) -> int:
        return self.static_bytes + self.pool_bytes

    def __call__(self, state: TrainState, batch: Batch,
                 generator: Optional[torch.Generator] = None,
                 seeds: Sequence[int] = ()) -> Tuple[TrainState, Metrics]:
        """One step; with a caller part, ``body(state, batch, generator,
        part, gens)``, ``gens`` the program's own generators (one a seed,
        registered with the graphs) seeded with ``seeds`` first."""
        cuda = self.device.type == "cuda"
        if cuda:
            require_capturable(state, "a train step program")
        if self._done is not None:  # the last call's copies out
            torch.cuda.current_stream(self.device).wait_event(self._done)
        with torch.no_grad():
            for k, v in batch.items():
                self.input[k].copy_(v)

        if self.part is None:
            def run():
                return self.body(state, self.input, generator)
        else:
            if self.own is None:
                self.own = [torch.Generator(self.device) for _ in seeds]
            for g, seed in zip(self.own, seeds):
                g.manual_seed(seed)

            def run():
                return self.body(state, self.input, generator, self.part,
                                 self.own)

        if not (self.warm and adam_ready(state)):
            with CACHE.building():
                _, metrics = warm_up(state, run, 1, self.device)
            self.warm = True
            return state, self._copy_out(metrics)
        adopt_cycle(state)
        now = binding(state)
        generators = (generator,) + tuple(self.own or ())
        if (self.binding is None or now != self.binding
                or len(generators) != len(self.generators)
                or any(a is not b for a, b in zip(generators,
                                                  self.generators))):
            # the stale graphs' pool goes back first; a capture that raises
            # leaves no binding, so the next call captures again
            self.graphs = self.binding = None
            if cuda:
                with CACHE.building():
                    self.graphs, self.pool_bytes = capture(
                        state, run, generators, self.device)
            self.binding, self.generators = now, generators
            self.captures += 1
        if cuda:
            metrics = replay(state, self.graphs)
        else:
            metrics = run()
            state.step += 1
        self.replays += 1
        return state, self._copy_out(metrics)

    def _copy_out(self, metrics: Metrics) -> Metrics:
        out = {k: v.detach().clone() for k, v in metrics.items()}
        if self.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(self.device))
        return out


def _mesh_key(mesh):
    """A mesh in a key: a ``Mesh`` by identity (the program's body holds
    it), PP's pair of stage devices by value."""
    if mesh is None or isinstance(mesh, tuple):
        return mesh
    return id(mesh)


def _key(kind: str, model, cfg, batch: Batch, accum_steps: int = 1,
         layout: str = "single", mesh=None, part: Optional[tuple] = None):
    device = next(model.parameters()).device
    return (kind, layout, _mesh_key(mesh), id(model), cfg, signature(batch),
            accum_steps, device, part), device


def train_program(state: TrainState, cfg, batch: Batch, body: TrainBody,
                  layout: str = "single", mesh=None,
                  part: Optional[tuple] = None) -> TrainProgram:
    """The cached train program of ``body`` for ``layout`` over ``mesh``,
    the state's model, ``cfg``, ``accum_steps``, the batch's signature and
    the caller's ``part`` (given to the body; None: none), built now if
    there is none (its binding is checked at each call)."""
    model = state.model
    key, device = _key("train", model, cfg, batch, state.accum_steps,
                       layout, mesh, part)
    return CACHE.lookup(key, model, lambda prog: True,
                        lambda: TrainProgram(model, body, batch, device,
                                             part))


def eval_program(model, cfg, batch: Batch, body: EvalBody,
                 layout: str = "single", mesh=None,
                 part: Optional[tuple] = None) -> infer_graphs.Program:
    """The cached eval program of ``body`` for ``layout`` over ``mesh``,
    ``model``, ``cfg``, the batch's signature and the caller's ``part``:
    the decode's :class:`infer.graphs.Program` over the batch (warmed up
    and captured when it is built, again when the model's binding moved),
    in ``no_grad``."""
    key, device = _key("eval", model, cfg, batch, 1, layout, mesh, part)
    return CACHE.lookup(
        key, model,
        lambda prog: prog.binding == infer_graphs.binding(model),
        lambda: infer_graphs.Program(model, body, batch, device,
                                     grad_mode=torch.no_grad))


def _on(state: TrainState, mesh) -> bool:
    if mesh is None:
        return programmed(next(state.model.parameters()).device)
    if isinstance(mesh, tuple):  # PP's pair of stage devices
        return stages_programmed(mesh)
    return mesh_programmed(mesh)


def train_step(cfg, body: TrainBody, layout: str = "single", mesh=None,
               check: Optional[Callable[[TrainState], None]] = None,
               prepare: Optional[Callable] = None):
    """``step(state, batch, generator) -> (state, metrics)``: one step of
    ``body`` (the step without its count) and the count, run as the cached
    program of its key where the steps are programs (:func:`programmed`,
    :func:`mesh_programmed` over ``mesh``, or :func:`stages_programmed`
    over PP's pair of stage devices), else eagerly.  ``check`` refuses a
    state the step cannot take, before either form runs.  ``prepare(state,
    batch, generator) -> (part, seeds)`` runs on the host before every call
    of either form: ``part`` joins the program's key, and the body is
    ``body(state, batch, generator, part, gens)``, ``gens`` one generator
    a seed, on ``generator``'s device: new ones in the eager form, the
    program's own in a program (registered with its graphs, re-seeded
    before every call).  The eager form is ``step.eager``.  A call is the
    span ``svs.train.step`` (the program's lookup, staging the batch, the
    replay, the host's bookkeeping, the metrics' copy-out)."""

    def eager(state: TrainState, batch: Batch,
              generator: Optional[torch.Generator] = None):
        if check is not None:
            check(state)
        if prepare is None:
            metrics = body(state, batch, generator)
        else:
            part, seeds = prepare(state, batch, generator)
            metrics = body(state, batch, generator, part, [
                torch.Generator(generator.device).manual_seed(s)
                for s in seeds])
        state.step += 1
        return state, metrics

    def step(state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None):
        with profiling.annotate("svs.train.step", always=True):
            if not _on(state, mesh):
                return eager(state, batch, generator)
            if check is not None:
                check(state)
            part, seeds = (prepare(state, batch, generator) if prepare
                           else (None, ()))
            return train_program(state, cfg, batch, body, layout, mesh,
                                 part)(state, batch, generator, seeds)

    step.eager = eager
    return step


def eval_step(cfg, body: EvalBody, layout: str = "single", mesh=None,
              check: Optional[Callable[[TrainState], None]] = None,
              prepare: Optional[Callable] = None):
    """``step(state, batch) -> metrics``: ``body(model, batch)`` in
    ``no_grad``, as the cached eval program of its key where the steps are
    programs, else eagerly; :func:`train_step`'s ``check`` and
    ``step.eager``; ``prepare(state, batch) -> part`` runs on the host
    before either form, ``part`` joining the program's key."""

    @torch.no_grad()
    def eager(state: TrainState, batch: Batch) -> Metrics:
        if check is not None:
            check(state)
        if prepare is not None:
            prepare(state, batch)
        return body(state.model, batch)

    def step(state: TrainState, batch: Batch) -> Metrics:
        if not _on(state, mesh):
            return eager(state, batch)
        if check is not None:
            check(state)
        part = prepare(state, batch) if prepare else None
        return eval_program(state.model, cfg, batch, body, layout, mesh,
                            part)(batch)

    step.eager = eager
    return step


# one a process, as jax.jit's cache is, so that its bound holds for it
CACHE = infer_graphs.ProgramCache(MAX_BYTES)

"""The decode's compiled programs: cached, captured CUDA graphs (the
counterpart of ``jax.jit``'s cache for svs_tpu's ``_separate_spec_jit``,
``_separate_wav_jit`` and ``_separate_wav_pcm16_jit``, svs_tpu
separate.py:114-122, 243-301).

svs_tpu compiles its decode once per static signature and bucketed shape
and runs the compiled program after that, so a song enters device memory
once and leaves as separated audio with no host work in between.  Here a
:class:`Program` is that program on the card: the decode's eager body
(``separate._separate_padded`` and kin, which stay plain functions and the
tests' oracle) captured into one ``torch.cuda.CUDAGraph`` over a static
input buffer, replayed for every later call of its key.

- **Key.** One program per (model, signature, padded shape, dtype, device,
  config): the signature is the body's function and its static arguments
  (``mode``, ``vocal_solo``, ``both``, PCM16), the padded shape the
  caller's bucket.  Beside the key a program holds its *binding*: the
  address of every ``state_dict()`` tensor, the parameters' dtype and the
  TF32 and cuDNN algorithm flags, which the graph bakes in.  A model whose tensors were rebound
  (``model.to(...)``, ``load_state_dict(assign=True)``) gets a new program
  in place of the stale one; weights updated in place (an optimiser step)
  keep their addresses, and the program reads them as they are.
- **Build.** Warm-up calls run eagerly on a side stream (they create the
  cuFFT plans of ``torch.fft.rfft`` / ``irfft`` and settle cuDNN's choice
  of algorithm), then the body is captured into static outputs in the
  graph's own memory pool (PyTorch's recipe, as ``train/scan.py``); the
  graph runs the cuFFT plans that PyTorch's plan cache holds (4,096 a
  device, far more than a run's decode shapes).  The
  capture's error mode is ``thread_local``: a server captures on its
  worker thread while handler threads run, and those touch no CUDA.  A
  capture that fails raises; nothing falls back to the eager body.
- **Calls.** A call copies its input into the static buffer, replays, and
  returns *copies* of the static outputs, all on the caller's current
  stream: a result never aliases a buffer that the next replay writes.  A
  call waits for the program's previous call on whatever stream that ran,
  so two streams or threads never share the buffers at once.
- **Memory.** A program's pool keeps the decode's activations that the
  eager path frees (and XLA frees after each call), so the cache holds at
  most :data:`MAX_BYTES` (the static inputs and the pools).  Past that
  bound the least recently used programs are dropped (the newest always
  stays, even alone past the bound); a dropped pool goes back to PyTorch's
  allocator.  The programs of a model that was freed are dropped at the
  next build.

On the CPU a program captures nothing: a call copies into its static
input, runs the body and returns its outputs, so the key, the buffers and
the copies run on the host too.  The entry points in ``separate.py`` take
programs on the card only.  The eval step's programs
(``train/graphs.eval_program``) are of this class too, over a batch dict.

The cache is one per process, as ``jax.jit``'s is, so that its bound holds
for the process; :data:`CACHE` is it.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref
from typing import Callable, Dict, Hashable, Optional

import torch
import torch.nn as nn

from svs_torch.utils import profiling

# The bound on the bytes all cached programs hold.  A program of the
# ``default`` preset holds 51-103 MB for a 60-s song and 143-245 MB for a
# 4-minute one (its pool is about the eager decode's peak; ``overlap`` the
# most; H100, ``chip_smoke.py``), so 4 GiB keeps the 12 signatures of a
# 4-minute bucket (3 modes x ``vocal_solo`` x f32 / PCM16, ~2 GB) and those
# of a shorter bucket beside them, and leaves 95 % of an 80-GB card to
# training and to other work.
MAX_BYTES = 4 << 30
# eager calls on a side stream before the capture (PyTorch's recipe): the
# first makes the cuFFT plans and cuDNN's choices, the second runs warm
WARMUP_CALLS = 2

# a body takes the model as an argument, so that a cached program holds no
# reference to it (the programs of a freed model can then be dropped)
Body = Callable[[nn.Module, object], object]


def binding(model: nn.Module) -> tuple:
    """What a captured program reads by address or bakes in: every
    ``state_dict()`` tensor's address, the parameters' dtype, the TF32
    flags of cuDNN and cuBLAS, and cuDNN's deterministic and benchmark
    flags (they choose the algorithms that the graph records)."""
    return (tuple(t.data_ptr() for t in model.state_dict().values()),
            next(model.parameters()).dtype,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)


def pool_bytes(record: Callable[[], None], device: torch.device) -> int:
    """``record()`` (a capture) and the bytes its pool took: the growth
    of the reserved bytes over it, after the cache's free blocks (a
    warm-up's) went back."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(device)
    record()
    return torch.cuda.memory_reserved(device) - before


def _static(x, device: torch.device):
    """An empty static buffer shaped as ``x`` (a tensor or a dict of
    them)."""
    if isinstance(x, dict):
        return {k: _static(v, device) for k, v in x.items()}
    return torch.empty(x.shape, dtype=x.dtype, device=device)


def _copy(dst, src) -> None:
    if isinstance(dst, dict):
        for k, v in dst.items():
            v.copy_(src[k])
    else:
        dst.copy_(src)


def _clone(outs):
    if isinstance(outs, dict):
        return {k: v.clone() for k, v in outs.items()}
    return tuple(o.clone() for o in outs)


class Program:
    """One program: ``body`` over a static input shaped as ``x`` (a tensor,
    or a dict of them: a batch), on ``device``; captured on a CUDA device,
    run eagerly on the CPU.  The body's outputs are a tuple or a dict of
    tensors.  ``grad_mode``: the autograd mode the body runs in; the
    decode's is inference mode, the eval step's (``train/graphs.py``)
    ``no_grad``: the ``matmul_bf16`` loss caches its DFT filter bank at
    first use (``losses/mrstft.py``), and a bank made in inference mode
    cannot be saved for a later train step's backward."""

    def __init__(self, model: nn.Module, body: Body, x, device: torch.device,
                 grad_mode=torch.inference_mode):
        self.model = weakref.ref(model)
        self.binding = binding(model)
        self.body = body
        self.device = device
        self.grad_mode = grad_mode
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = ()
        self._lock = threading.Lock()
        with grad_mode():
            self.input = _static(x, device)
            _copy(self.input, x)
            pool = self._capture(model) if device.type == "cuda" else 0
        inputs = (self.input.values() if isinstance(self.input, dict)
                  else (self.input,))
        self.nbytes = pool + sum(t.nbytes for t in inputs)

    def _capture(self, model: nn.Module) -> int:
        """Warm up, capture; returns the bytes of the graph's pool."""
        dev = self.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    self.body(model, self.input)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()

            def record():
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    self.outputs = self.body(model, self.input)

            nbytes = pool_bytes(record, dev)
            self.graph = graph
            self._done = torch.cuda.Event()
            return nbytes

    def __call__(self, x):
        """The body on ``x`` (any device; its shapes and dtypes the
        program's): fresh tensors on the program's device."""
        with self._lock, self.grad_mode():
            if self.graph is None:
                _copy(self.input, x)
                return _clone(self.body(self.model(), self.input))
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._done)  # the last call's copies
            _copy(self.input, x)
            self.graph.replay()
            outs = _clone(self.outputs)
            self._done.record(stream)
            return outs


class ProgramCache:
    """The programs by key, least recently used first, within
    ``max_bytes``.  Its counters are published to the profiling registry
    (``profiling.snapshot()['counters']``, summed over the live caches)."""

    def __init__(self, max_bytes: int = MAX_BYTES):
        self.max_bytes = max_bytes
        self.builds = 0  # programs built (captured on the card)
        self.evictions = 0  # programs dropped past the bound
        self.build_s = 0.0  # seconds in builds (:meth:`building`)
        self._programs: "collections.OrderedDict[Hashable, Program]" = (
            collections.OrderedDict())
        # re-entrant: a lookup builds under it, and the build adds its
        # seconds under it
        self._lock = threading.RLock()
        profiling.publish(self)

    def counters(self) -> Dict[str, float]:
        return {"program.builds": self.builds,
                "program.evictions": self.evictions,
                "program.build_s": self.build_s}

    @contextlib.contextmanager
    def building(self):
        """A build of one of this cache's programs (a lookup's, or a train
        program's eager warm-up and capture at a later call): the span
        ``svs.program.build`` (``always``), its seconds added to
        ``build_s``."""
        t0 = time.perf_counter()
        try:
            with profiling.annotate("svs.program.build", always=True):
                yield
        finally:
            with self._lock:
                self.build_s += time.perf_counter() - t0

    def __len__(self) -> int:
        return len(self._programs)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self._programs.values())

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()

    def programs_of(self, model: nn.Module) -> list:
        """The cached programs of ``model``, least recently used first."""
        with self._lock:
            return [p for p in self._programs.values()
                    if p.model() is model]

    def program(self, model: nn.Module, signature: Hashable,
                x: torch.Tensor, body: Body) -> Program:
        """The program of ``signature`` on ``x``'s shape and dtype for
        ``model`` (on its device): the cached one if its binding still
        holds, else one built now from ``body`` with ``x`` as its first
        input."""
        device = next(model.parameters()).device
        key = (id(model), signature, tuple(x.shape), x.dtype, device,
               model.cfg)
        return self.lookup(key, model,
                           lambda prog: prog.binding == binding(model),
                           lambda: Program(model, body, x, device))

    def lookup(self, key: Hashable, model: nn.Module,
               fresh: Callable[[object], bool], build: Callable[[], object]):
        """The program of ``key`` for ``model`` if it is cached and
        ``fresh``, else the one ``build`` makes now; the programs past the
        bound go, least recently used first (the one returned always
        stays).  A program has ``model`` (a weak reference) and ``nbytes``,
        which may grow after it is built (``train/graphs.py``'s capture at
        a later call): the bound is kept at every lookup."""
        with self._lock:
            prog = self._programs.get(key)
            if (prog is not None and prog.model() is model
                    and fresh(prog)):
                self._programs.move_to_end(key)
            else:
                # a stale program of this key (rebound tensors, or a freed
                # model whose id was reused) and those of freed models go
                for k in [k for k, p in self._programs.items()
                          if k == key or p.model() is None]:
                    del self._programs[k]
                with self.building():
                    prog = build()
                self.builds += 1
                self._programs[key] = prog
            while len(self._programs) > 1 and self.nbytes > self.max_bytes:
                self._programs.popitem(last=False)
                self.evictions += 1
            return prog


CACHE = ProgramCache()

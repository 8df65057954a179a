"""A pool of local ranks: ``size`` worker processes on this host, each one
rank of one process group, which run functions on request.

    with Ranks(2) as ranks:                   # two gloo ranks on the CPU
        out = ranks.run(dryrun.dp_smoke_rank)

Each rank is a one-worker ``ProcessPoolExecutor`` of the ``spawn`` context
whose initializer sets ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``GROUP_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), so the ``mesh.make_mesh`` of its first
call joins the pool's group as a ``torchrun`` rank's would.  ``hosts``
cuts the pool into that many hosts of consecutive ranks, as ``torchrun
--nnodes`` would (``Ranks(4, hosts=2)``: two hosts of two ranks).
``run(fn, ...)`` calls ``fn(mesh, *args, **kwargs)`` on every rank;
``fn`` is a module-level function, and its
arguments and values are pickled (return numpy arrays or CPU tensors).  A
spawned worker imports the function's module and the caller's main script
(without running its ``__main__`` block), never the caller's other
modules: the tests run the port's ranks this way with no JAX in them, and
start their pool once.  An exception on any rank (``SystemExit``
included), a dead worker or the timeout raises ``RuntimeError`` here, and
the pool starts anew at its next call.
"""

from __future__ import annotations

import atexit
import concurrent.futures as cf
import multiprocessing
import os
import socket
from typing import Callable, List, Optional

# the mesh a worker's calls get, made at its first call from the
# initializer's (device, backend)
_spec: Optional[tuple] = None
_mesh = None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_rank(env: dict, device: str, backend: Optional[str]) -> None:
    """A worker's initializer, before it imports torch: the rank's
    environment, and its standard output sent to standard error (the
    caller's output stays its own)."""
    global _spec
    os.environ.update(env)
    os.dup2(2, 1)
    _spec = (device, backend)


def _call(fn: Callable, args: tuple, kwargs: dict):
    global _mesh
    if _mesh is None:
        import torch.distributed as dist

        from svs_torch.parallel.mesh import make_mesh

        _mesh = make_mesh(device=_spec[0], backend=_spec[1])
        atexit.register(dist.destroy_process_group)
    return fn(_mesh, *args, **kwargs)


class Ranks:
    """``size`` local ranks of one process group on ``device`` (``cpu``,
    ``cuda`` for ``cuda:LOCAL_RANK``, or one card such as ``cuda:0`` for
    every rank) over ``backend`` (NCCL on CUDA and gloo on the CPU unless
    given), each with one intra-op thread (``OMP_NUM_THREADS=1``: the
    ranks share the host's cores), cut into ``hosts`` hosts of ``size //
    hosts`` consecutive ranks each (``torchrun``'s nodes: ``GROUP_RANK``,
    ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` per rank).  ``timeout``:
    seconds that one call may take."""

    def __init__(self, size: int, *, device: str = "cpu",
                 backend: Optional[str] = None, timeout: float = 600.0,
                 hosts: int = 1):
        if size < 1:
            raise ValueError(f"a pool needs at least one rank, got {size}")
        if hosts < 1 or size % hosts:
            raise ValueError(f"{size} ranks do not split into {hosts} hosts "
                             "of one size")
        self.size = size
        self.hosts = hosts
        self.device = device
        self.backend = backend
        self.timeout = timeout
        self._pools: List[cf.ProcessPoolExecutor] = []

    def _start(self) -> None:
        env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(self.size), OMP_NUM_THREADS="1")
        local = self.size // self.hosts
        env["LOCAL_WORLD_SIZE"] = str(local)
        spawn = multiprocessing.get_context("spawn")
        self._pools = [cf.ProcessPoolExecutor(
            1, mp_context=spawn, initializer=_init_rank,
            initargs=(dict(env, RANK=str(r), LOCAL_RANK=str(r % local),
                           GROUP_RANK=str(r // local)), self.device,
                      self.backend)) for r in range(self.size)]

    def close(self, kill: bool = False) -> None:
        """Stop every worker; with ``kill``, at once (a rank may wait in a
        collective that will never complete)."""
        for pool in self._pools:
            if kill:  # ProcessPoolExecutor has no public kill before 3.14
                for p in list(pool._processes.values()):
                    p.kill()
            pool.shutdown(wait=True, cancel_futures=True)
        self._pools = []

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, fn: Callable, *args, **kwargs) -> list:
        """``fn(mesh, *args, **kwargs)`` on every rank; their values in rank
        order."""
        if not self._pools:
            self._start()
        futures = [p.submit(_call, fn, args, kwargs) for p in self._pools]
        done, pending = cf.wait(futures, self.timeout,
                                return_when=cf.FIRST_EXCEPTION)
        if pending and any(f.exception() for f in done):
            # the others may wait in a collective with the failed rank
            done, pending = cf.wait(futures, 20)
        errors = [f"[rank {r}] {type(e).__name__}: {e}"
                  + (f"\n{e.__cause__}" if e.__cause__ else "")
                  for r, f in enumerate(futures)
                  if f in done and (e := f.exception()) is not None]
        if pending:
            late = sorted(futures.index(f) for f in pending)
            errors.append(f"rank(s) {late} still running after "
                          f"{self.timeout} s")
        if errors:
            self.close(kill=True)
            raise RuntimeError(f"{fn.__module__}.{fn.__name__} failed:\n"
                               + "\n".join(errors))
        return [f.result() for f in futures]

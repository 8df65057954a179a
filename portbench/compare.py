"""The numbers that decide ``correct``: how far the program's readings lie
from the reference's.  Plain torch and numpy on host tensors."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

# a leaf whose reference gradient norm is under this share of the median
# leaf's has a gradient of round-off and moves under Adam by round-off
# alone (a conv bias ahead of a train-mode BatchNorm): it is left out of
# the gradient's and the change's comparisons
STILL = 1e-3


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    """The widest relative gap between the steps' losses."""
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(program, reference))


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in
            leaves.items()}


def leaf_gaps(program: Dict[str, torch.Tensor],
              reference: Dict[str, torch.Tensor],
              names: Iterable[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    names = list(names)
    p, r = norms({k: program[k] for k in names}), norms(
        {k: reference[k] for k in names})
    med = statistics.median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in names}


def leaf_gap(program, reference, names) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(program, reference, names).values())


def moving(grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding:
    at least :data:`STILL` of the median leaf's norm."""
    n = norms(grads)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= STILL * med]


def block_errors(answer: np.ndarray, reference: np.ndarray,
                 block: int) -> np.ndarray:
    """An audio answer's relative error block by block: over blocks of
    ``block`` samples (the last one shorter), ||answer - reference|| over
    the larger of the reference block's norm and the median block's; inf
    for an answer of the wrong length."""
    a = np.asarray(answer, np.float64)
    r = np.asarray(reference, np.float64)
    if a.shape != r.shape:
        return np.array([np.inf])
    edges = list(range(0, len(r), block)) + [len(r)]
    err = np.array([np.linalg.norm(a[i:j] - r[i:j])
                    for i, j in zip(edges[:-1], edges[1:])])
    ref = np.array([np.linalg.norm(r[i:j])
                    for i, j in zip(edges[:-1], edges[1:])])
    return err / np.maximum(np.maximum(ref, np.median(ref)), 1e-30)


def block_error(answer: np.ndarray, reference: np.ndarray,
                block: int) -> float:
    """The worst block's relative error (:func:`block_errors`)."""
    return float(np.max(block_errors(answer, reference, block)))

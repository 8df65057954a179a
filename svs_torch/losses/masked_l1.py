"""Spectrogram-domain mask losses (port of ``svs_tpu/losses/masked_l1.py``).

The reference's runnable loss path (reference train.py:274-283) is two plain
L1 terms on masked magnitudes; its ``WeightedL1Loss`` class carries two latent
bugs (``self.reduction`` never assigned, and a 3-arg signature train.py never
satisfies), so the experiments actually ran ``nn.L1Loss``.  Here:

- :func:`masked_l1_pair` is the runnable-path semantics (the default),
- :func:`weighted_l1` is the *intended* weighted loss with the reduction bug
  fixed, offered as an option.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from svs_torch.parallel.mesh import Mesh, all_sum


def abs_like_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at an exact 0 is +1, as ``jnp.abs``'s
    (``select(x >= 0, g, -g)``); ``torch.abs`` gives 0 there.  Ties are
    real at a perfect prediction (the log-magnitude L1 of an exact match)."""
    return torch.where(x >= 0, x, -x)


def l1(pred: torch.Tensor, target: torch.Tensor,
       weight: torch.Tensor = None,
       group: Optional[Mesh] = None) -> torch.Tensor:
    """``nn.L1Loss`` (mean reduction).

    ``weight`` is an optional per-example ``(B,)`` 0/1 validity mask: the
    mean then runs over real examples only, so a padded batch reproduces the
    unpadded loss exactly.  ``group``: the data mesh whose ranks hold the
    rest of the batch (``weight`` is then required); the sums of
    ``w*|diff|`` and of ``weight`` are then the global batch's.
    """
    diff = abs_like_jax(pred - target)
    if weight is None:
        return torch.mean(diff)
    w = weight.reshape(weight.shape + (1,) * (diff.ndim - 1))
    per_example = math.prod(diff.shape[1:])
    s = all_sum(torch.stack([torch.sum(w * diff), torch.sum(weight)]), group)
    return s[0] / (s[1] * per_example)


def masked_l1_pair(mask, mix, voc, weight=None, group=None):
    """L1(mask*mix, voc) + L1((1-mask)*mix, clamp(mix-voc, 0))
    (reference train.py:274-283). Returns (total, pred_vocal)."""
    pred_vocal = mask * mix
    pred_accomp = (1.0 - mask) * mix
    target_accomp = torch.clamp(mix - voc, min=0.0)
    total = (l1(pred_vocal, voc, weight, group)
             + l1(pred_accomp, target_accomp, weight, group))
    return total, pred_vocal


def weighted_l1(target_vocal, target_mix, mask, reduction: str = "mean"):
    """Fixed version of reference WeightedL1Loss (model.py:15-40): each L1
    term elementwise-weighted by its per-row summed L1 difference."""
    pred_vocal = mask * target_mix
    pred_accomp = (1.0 - mask) * target_mix
    target_accomp = torch.clamp(target_mix - target_vocal, min=0.0)

    def weighted(pred, target):
        diff = abs_like_jax(pred - target)
        return diff * torch.sum(diff, dim=-1, keepdim=True)

    loss = (weighted(pred_vocal, target_vocal)
            + weighted(pred_accomp, target_accomp))
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss

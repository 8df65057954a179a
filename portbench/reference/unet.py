"""The plain U-Net mask estimator, in float32 (zouyuoz/SVS-UNet-PyTorch
``model.py``): the reference that ``correct`` holds the program to.

It imports nothing of the program.  Parameters are a dict under the
published model's state-dict names (``conv{i}.0`` conv, ``conv{i}.1``
BatchNorm, ``deconv{i}`` transposed conv, ``deconv{i}_BAD.0`` BatchNorm),
so one set of seeded tensors feeds both sides.

- encoder: 6 x [conv 5x5 stride 2 pad 2 -> BatchNorm -> LeakyReLU(0.2)]
- decoder: 6 x transposed conv 5x5 stride 2 pad 2 output_padding 1; the
  first five followed by [BatchNorm -> ReLU -> Dropout2d(0.5)], each
  decoder level after the first taking [previous, encoder skip] channels
- sigmoid mask over (B, F, T) magnitudes

``conv`` is the convolution to use: :func:`conv_f32` (float32, the
reference), or a lower-precision one (``precision.py``, the control).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
# conv(x, weight, bias, transpose) -> y
Conv = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, bool],
                torch.Tensor]

LEVELS = 6
KERNEL, STRIDE, PAD = 5, 2, 2
LEAKY_SLOPE = 0.2
DROPOUT = 0.5


def conv_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             transpose: bool) -> torch.Tensor:
    if transpose:
        return F.conv_transpose2d(x, w, b, STRIDE, PAD, output_padding=1)
    return F.conv2d(x, w, b, STRIDE, PAD)


def param_shapes(enc_channels) -> Dict[str, Tuple[int, ...]]:
    """Every state-dict tensor of the model with its shape, in the
    published model's order (BatchNorm's ``num_batches_tracked`` left
    out: nothing reads it)."""
    e = (1,) + tuple(enc_channels)
    shapes: Dict[str, Tuple[int, ...]] = {}

    def bn(prefix, c):
        for name in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{name}"] = (c,)

    for i in range(1, LEVELS + 1):
        shapes[f"conv{i}.0.weight"] = (e[i], e[i - 1], KERNEL, KERNEL)
        shapes[f"conv{i}.0.bias"] = (e[i],)
        bn(f"conv{i}.1", e[i])
    for i, (cin, cout) in enumerate(decoder_io(enc_channels), start=1):
        shapes[f"deconv{i}.weight"] = (cin, cout, KERNEL, KERNEL)
        shapes[f"deconv{i}.bias"] = (cout,)
        if i < LEVELS:
            bn(f"deconv{i}_BAD.0", cout)
    return shapes


def decoder_io(enc_channels) -> List[Tuple[int, int]]:
    """(in, out) channels of the six transposed convs."""
    e = tuple(enc_channels)
    return ([(e[5], e[4])] + [(e[i] * 2, e[i - 1]) for i in (4, 3, 2, 1)]
            + [(e[0] * 2, 1)])


def dropout_channels(enc_channels) -> List[int]:
    """Output channels of decoder levels 1..5, the Dropout2d masks'."""
    return [cout for _, cout in decoder_io(enc_channels)[:LEVELS - 1]]


def batch_norm(x: torch.Tensor, p: Params, prefix: str, train: bool,
               eps: float, stats: Optional[list]) -> torch.Tensor:
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            stats.append((prefix, mean.detach(), var.detach()))
    else:
        mean, var = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
    scale = p[f"{prefix}.weight"] * torch.rsqrt(var + eps)
    return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
            + p[f"{prefix}.bias"][None, :, None, None])


def forward(p: Params, mag: torch.Tensor, *, train: bool,
            keeps: Optional[List[torch.Tensor]] = None,
            conv: Conv = conv_f32, eps: float = 1e-5,
            stats: Optional[list] = None) -> torch.Tensor:
    """(B, F, T) magnitudes -> (B, F, T) sigmoid mask.

    train: BatchNorm on the batch's statistics (appended to ``stats`` as
    ``(prefix, mean, biased var)`` when given) and Dropout2d with the
    (B, C, 1, 1) 0/1 ``keeps`` of decoder levels 1..5; else BatchNorm on
    the running statistics and no dropout."""
    x = mag.to(torch.float32)[:, None]
    skips = []
    for i in range(1, LEVELS + 1):
        x = conv(x, p[f"conv{i}.0.weight"], p[f"conv{i}.0.bias"], False)
        x = batch_norm(x, p, f"conv{i}.1", train, eps, stats)
        x = torch.where(x >= 0, x, LEAKY_SLOPE * x)
        skips.append(x)
    for i in range(1, LEVELS):
        inp = skips[5] if i == 1 else torch.cat([x, skips[6 - i]], dim=1)
        x = conv(inp, p[f"deconv{i}.weight"], p[f"deconv{i}.bias"], True)
        x = batch_norm(x, p, f"deconv{i}_BAD.0", train, eps, stats)
        x = torch.relu(x)
        if train:
            x = x * keeps[i - 1] / (1.0 - DROPOUT)
    x = conv(torch.cat([x, skips[0]], dim=1), p["deconv6.weight"],
             p["deconv6.bias"], True)
    return torch.sigmoid(x)[:, 0]


def dropout_keeps(batch: int, enc_channels, generator: torch.Generator,
                  device) -> List[torch.Tensor]:
    """One training step's Dropout2d keep masks, decoder levels 1..5 in
    order, each a (B, C, 1, 1) Bernoulli(0.5) draw from ``generator``."""
    return [torch.bernoulli(torch.full((batch, c, 1, 1), 1.0 - DROPOUT,
                                       device=device), generator=generator)
            for c in dropout_channels(enc_channels)]

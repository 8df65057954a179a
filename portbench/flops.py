"""The U-Net's convolution FLOPs, counted from shapes.

A convolution of ``cin -> cout`` channels with a k x k kernel does
2 * cin * cout * k^2 multiply-adds' FLOPs per output pixel; a transposed
convolution does the same per *input* pixel (each input pixel is spread
over k^2 outputs).  Only the encoder's convs and the decoder's transposed
convs are counted: not their bias adds, BatchNorm, activations, the mask,
the loss or the optimiser.  So the count is the same whatever implements
them or the loss, and the FLOP shares built on it measure how well the
device runs the model's own work.

Training counts forward and backward: each conv's weight gradient, and
its input gradient except the first encoder conv's, whose input (the
magnitudes) needs none.  Remat's recomputed forward is not counted: it is
not work the model asks for.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

KERNEL, STRIDE = 5, 2


def _levels(freq: int, frames: int, enc_channels) -> List[Tuple]:
    """(cin, cout, pixels) of each conv in forward order; ``pixels`` the
    output's for a conv, the input's for a transposed conv."""
    e = (1,) + tuple(enc_channels)
    out, h, w = [], freq, frames
    for i in range(1, 7):
        h, w = h // STRIDE, w // STRIDE
        out.append((e[i - 1], e[i], h * w))
    dec = ([(e[6], e[5])] + [(e[i] * 2, e[i - 1]) for i in (5, 4, 3, 2)]
           + [(e[1] * 2, 1)])
    for cin, cout in dec:
        out.append((cin, cout, h * w))
        h, w = h * STRIDE, w * STRIDE
    return out


def forward_flops(freq: int, frames: int, enc_channels) -> int:
    """FLOPs of one forward pass over one (freq, frames) patch."""
    return sum(2 * cin * cout * KERNEL * KERNEL * px
               for cin, cout, px in _levels(freq, frames, enc_channels))


def train_flops(freq: int, frames: int, enc_channels) -> int:
    """FLOPs of forward and backward over one patch: three times the
    forward, less the first conv's input gradient."""
    levels = _levels(freq, frames, enc_channels)
    cin, cout, px = levels[0]
    first = 2 * cin * cout * KERNEL * KERNEL * px
    return 3 * forward_flops(freq, frames, enc_channels) - first


def for_config(cfg: Dict) -> Dict[str, int]:
    """Per-patch forward and training FLOPs at ``cfg``'s patch."""
    args = (cfg["freq_bins"], cfg["input_len"], cfg["enc_channels"])
    return {"forward": forward_flops(*args), "train": train_flops(*args)}

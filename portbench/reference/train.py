"""The reference's training steps: the float32 U-Net in train mode, the
combined loss, autograd's gradients and a plain Adam update (torch's
defaults, reference ``model.py:116``: betas 0.9 / 0.999, eps 1e-8, no
weight decay).  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import dsp, unet

BETAS = (0.9, 0.999)
EPS = 1e-8


def trainable(shapes: Dict[str, tuple]) -> List[str]:
    """The names Adam updates: every weight and bias (running statistics
    are buffers)."""
    return [k for k in shapes if not k.endswith(("running_mean",
                                                 "running_var"))]


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], names, lr: float):
        self.names, self.lr, self.t = list(names), lr, 0
        self.m = {k: torch.zeros_like(params[k]) for k in self.names}
        self.v = {k: torch.zeros_like(params[k]) for k in self.names}

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k in self.names:
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / c2).sqrt_().add_(EPS)
            params[k] = params[k] - self.lr * (self.m[k] / c1) / denom


def step(params: Dict[str, torch.Tensor], opt: Adam, batch, keeps,
         cfg: dict, conv=unet.conv_f32, mag=dsp.spectral_mag):
    """One training step in place of ``params``: returns (loss,
    gradients by name).  ``conv`` and ``mag``: the convolution and the
    loss's magnitudes (the control's lower precision in their place)."""
    leaves = {k: params[k].detach().requires_grad_(True)
              for k in opt.names}
    p = dict(params, **leaves)
    mask = unet.forward(p, batch["mix"], train=True, keeps=keeps,
                        conv=conv, eps=cfg["bn_eps"])
    total, _, _ = dsp.combined_loss(mask, batch["mix"], batch["voc"],
                                    batch["mix_angle"], batch["voc_angle"],
                                    cfg, mag)
    grads = dict(zip(opt.names, torch.autograd.grad(
        total, [leaves[k] for k in opt.names])))
    opt.step(params, grads)
    return float(total.detach()), grads

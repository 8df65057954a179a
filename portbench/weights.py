"""Seeded U-Net weights, made on the device in one call, and handed alike to
the program and to the reference.

Conv and transposed-conv weights and biases are uniform in
+-1/sqrt(fan_in) (torch's default initialisation, fan_in =
weight.size(1) * k * k); BatchNorm scales are uniform in [0.8, 1.2] and
shifts in [-0.1, 0.1], so that the normalisation's parameters take part;
running statistics are 0 and 1 until :func:`calibrate` sets them.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import unet


def make(seed: int, enc_channels, device) -> Dict[str, torch.Tensor]:
    """Every parameter and running statistic by state-dict name, float32
    on ``device``, from one ``torch.rand`` draw of ``seed``."""
    shapes = unet.param_shapes(enc_channels)
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    gen = torch.Generator(device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        r = u[at:at + n].reshape(shape)
        at += n
        kind = name.rsplit(".", 1)[-1]
        if (name.startswith("conv") and ".0." in name) or (
                name.startswith("deconv") and "_BAD" not in name):
            # a conv's or a transposed conv's weight or bias
            w = shapes[name.rsplit(".", 1)[0] + ".weight"]
            out[name] = r / (w[1] * unet.KERNEL * unet.KERNEL) ** 0.5
        elif kind == "weight":
            out[name] = 1.0 + 0.2 * r
        elif kind == "bias":
            out[name] = 0.1 * r
        elif kind == "running_mean":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


@torch.no_grad()
def calibrate(params: Dict[str, torch.Tensor], mags: torch.Tensor,
              eps: float) -> None:
    """Make the eval-mode model on ``mags`` (B, F, T) behave as a trained
    one: every BatchNorm's running statistics set to those of a train-mode
    forward over ``mags`` (with the initial 0 and 1, activations shrink
    level by level and the mask sits at its bias), then the last
    transposed conv scaled and shifted so that the mask's logits over
    ``mags`` have mean 0 and spread 1 (so every seed's mask is as
    sensitive to its input)."""
    stats = []
    keeps = [torch.ones(mags.shape[0], c, 1, 1, device=mags.device)
             for c in unet.dropout_channels(_channels(params))]
    unet.forward(params, mags, train=True, keeps=keeps, eps=eps,
                 stats=stats)
    for prefix, mean, var in stats:
        params[f"{prefix}.running_mean"] = mean.clone()
        params[f"{prefix}.running_var"] = var.clone()
    mask = unet.forward(params, mags, train=False, eps=eps).double()
    logit = torch.log(mask.clamp(1e-12, 1 - 1e-12)) - torch.log1p(
        -mask.clamp(1e-12, 1 - 1e-12))
    mu, sd = logit.mean(), logit.std().clamp(min=1e-6)
    params["deconv6.weight"] = (params["deconv6.weight"] / sd).float()
    params["deconv6.bias"] = ((params["deconv6.bias"] - mu) / sd).float()


def _channels(params) -> tuple:
    return tuple(params[f"conv{i}.0.bias"].shape[0] for i in range(1, 7))


@torch.no_grad()
def load_into(model: torch.nn.Module, params: Dict[str, torch.Tensor]):
    """Copy ``params`` into the program's model, in place (a program that
    holds the tensors' addresses keeps them)."""
    state = model.state_dict()
    for name, value in params.items():
        state[name].copy_(value)

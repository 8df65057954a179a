"""U-Net mask estimator (port of ``svs_tpu/models/unet.py``).

Architecture contract (reference model.py:42-201):

- encoder: 6 x [Conv 5x5 stride 2 pad 2 -> BatchNorm -> LeakyReLU(0.2)],
  channels 1->16->32->64->128->256->512, spatial (512,128) -> (8,2)
- decoder: 6 x ConvTranspose 5x5 stride 2 pad 2 output_padding 1 (the
  reference pins ``output_size`` to the mirror encoder shape, which is
  exactly 2x here); the first five are followed by
  [BatchNorm -> ReLU -> Dropout2d(0.5)]
- skip connections: channel concat [decoder_out, encoder_out]
- final sigmoid -> soft mask in [0, 1]

The module's state-dict keys are the reference's (``conv{i}.0/.1``,
``deconv{i}``, ``deconv{i}_BAD.0``), so reference ``.pth`` files load with
``load_state_dict``.  The public forward keeps the JAX package's layout:
``(B, F, T)`` magnitudes in, ``(B, F, T)`` float32 mask out.

Compute dtype (``cfg.compute_dtype``) follows svs_tpu exactly with explicit
casts rather than autocast: conv inputs and weights are cast to the compute
dtype, the conv output and the bias add stay in it, BatchNorm statistics
stay float32 while the normalisation runs in the activation dtype
(unet.py:208-210), and the sigmoid runs in float32 (unet.py:415).

``cfg.remat`` recomputes each encoder and decoder level in the backward
pass instead of keeping its activations (``torch.utils.checkpoint``,
non-reentrant; svs_tpu's ``jax.checkpoint`` per level, unet.py:340-346).
The levels are pure functions of their inputs for that: the BatchNorm
running statistics a level returns are written after it (once, not again
in the recomputation), and a decoder level's Dropout2d mask is drawn from
the generator before the level and passed in, so the recomputation
replays the same mask.  The numbers are those without remat.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from svs_torch.parallel.mesh import Mesh, all_sum
from svs_torch.utils.config import SVSConfig
from svs_torch.utils.device import torch_dtype


def batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    *,
    train: bool,
    eps: float,
    momentum: float,
    weight: Optional[torch.Tensor] = None,
    group: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """torch BatchNorm2d semantics on NCHW, after svs_tpu unet.py:166-211.

    Train mode normalises with the per-batch biased variance and returns
    running stats updated with the unbiased variance.  ``weight`` is an
    optional per-example (B,) 0/1 validity mask: batch statistics are then
    taken over real examples only (``nn.BatchNorm2d`` cannot do that).
    Statistics stay float32; the normalisation runs in ``x``'s dtype.

    ``group``: the data mesh whose ranks hold the rest of the batch.  The
    statistics are then the global weighted batch's (sync-BN, svs_tpu
    dp.py:6-10), in svs_tpu's two passes: the mean from the all-reduced
    ``sum(w*x)`` and ``sum(w)``, then the variance from the all-reduced
    ``sum(w*(x-mean)^2)`` (``weight`` is then required); the unbiased factor
    takes the global count, and the backward all-reduces through the same
    sums.

    Returns ``(y, new_mean, new_var)``.
    """
    if train:
        axes = (0, 2, 3)
        x32 = x.to(torch.float32)
        if weight is None:
            batch_mean = x32.mean(dim=axes)
            batch_var = x32.var(dim=axes, unbiased=False)
            n = x.shape[0] * x.shape[2] * x.shape[3]
        else:
            w = weight.to(torch.float32)[:, None, None, None]
            s = all_sum(torch.cat([(w * x32).sum(dim=axes),
                                   weight.to(torch.float32).sum()[None]]),
                        group)
            n = s[-1] * (x.shape[2] * x.shape[3])
            batch_mean = s[:-1] / n
            batch_var = all_sum(
                (w * (x32 - batch_mean[None, :, None, None]) ** 2
                 ).sum(dim=axes), group) / n
        if not isinstance(n, torch.Tensor):
            # made on the device (a fill, not a host copy: a CUDA graph
            # captures no pageable copy)
            n = torch.full((), n, dtype=torch.float32, device=x.device)
        unbiased = batch_var * (n / torch.clamp(n - 1, min=1))
        new_mean = (1 - momentum) * mean + momentum * batch_mean
        new_var = (1 - momentum) * var + momentum * unbiased
        use_mean, use_var = batch_mean, batch_var
    else:
        new_mean, new_var = mean, var
        use_mean, use_var = mean, var
    inv = torch.rsqrt(use_var + eps)

    def c(v):  # per-channel vector broadcast over NCHW, in x's dtype
        return v.to(x.dtype)[None, :, None, None]

    y = (x - c(use_mean)) * c(inv * scale) + c(bias)
    return y, new_mean, new_var


class BatchNorm(nn.Module):
    """BatchNorm2d parameters and buffers under torch's names (so reference
    state dicts load); the U-Net's levels apply them by :func:`batch_norm`
    and write the running statistics back with :meth:`update`."""

    def __init__(self, channels: int, eps: float, momentum: float):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    @torch.no_grad()
    def update(self, new_mean: torch.Tensor, new_var: torch.Tensor) -> None:
        """Write a train-mode call's new running statistics."""
        self.running_mean.copy_(new_mean)
        self.running_var.copy_(new_var)
        self.num_batches_tracked += 1


def dropout_keep(shape, rate: float, device,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dropout2d's (B, C, 1, 1) keep mask for a (B, C, H, W) activation,
    drawn from ``generator``."""
    return torch.bernoulli(torch.full((shape[0], shape[1], 1, 1), 1.0 - rate,
                                      device=device), generator=generator)


def dropout2d(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator] = None,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch Dropout2d: drop whole channel maps, scale survivors by
    1/(1-p), with the keep mask drawn from ``generator`` (or given)."""
    if keep is None:
        keep = dropout_keep(x.shape, rate, x.device, generator)
    return x * keep.to(x.dtype) / (1.0 - rate)


def decoder_io(enc_channels) -> list:
    """(in, out) channels of the six deconvs (unet.py:257-266): deconv1
    takes the bottleneck alone, deconv i>1 takes [prev, enc(6-i)]."""
    e = tuple(enc_channels)
    return ([(e[5], e[4])]
            + [(e[i] * 2, e[i - 1]) for i in (4, 3, 2, 1)]
            + [(e[0] * 2, 1)])


class UNet(nn.Module):
    """The reference U-Net (model.py:42-201) as an NCHW ``nn.Module``.

    ``generator`` seeds the initial weights: torch's default conv init,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias (the bounds of
    svs_tpu ``unet.init``), BN scale 1, bias 0, running mean 0, var 1.
    """

    def __init__(self, cfg: Optional[SVSConfig] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = cfg or SVSConfig()
        self.cfg = cfg
        k, s = cfg.kernel_size, cfg.stride
        pad = k // 2
        chans = (1,) + tuple(cfg.enc_channels)
        for i in range(1, 7):
            self.add_module(f"conv{i}", nn.Sequential(
                nn.Conv2d(chans[i - 1], chans[i], k, s, pad),
                BatchNorm(chans[i], cfg.bn_eps, cfg.bn_momentum)))
        for i, (cin, cout) in enumerate(decoder_io(cfg.enc_channels),
                                        start=1):
            self.add_module(f"deconv{i}", nn.ConvTranspose2d(
                cin, cout, k, s, pad, output_padding=s - 1))
            if i < 6:
                self.add_module(f"deconv{i}_BAD", nn.Sequential(
                    BatchNorm(cout, cfg.bn_eps, cfg.bn_momentum)))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        k = self.cfg.kernel_size
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # Conv2d weight (O, I, k, k), ConvTranspose2d (I, O, k, k):
                # torch's fan_in is weight.size(1) * k * k for both
                bound = 1.0 / (m.weight.shape[1] * k * k) ** 0.5
                for p in (m.weight, m.bias):
                    p.copy_(torch.rand(p.shape, generator=generator)
                            * (2 * bound) - bound)
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()

    def forward(self, mix: torch.Tensor, *,
                weight: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        """Sigmoid soft mask for magnitude patches.

        Args:
          mix: (B, F, T) magnitudes, F and T multiples of 64.
          weight: optional (B,) 0/1 validity mask for train-mode BatchNorm.
          generator: Dropout2d's random source in train mode.
          mesh: the data mesh when ``mix`` is this rank's block of a global
            batch (``parallel.mesh.shard_batch``): BatchNorm takes the
            global batch's statistics, and each Dropout2d mask is drawn at
            the global padded batch's shape, the same on every rank from
            a generator seeded alike, and cut to this rank's rows (svs_tpu
            draws one (B_global, C) mask from a replicated key).

        Returns the (B, F, T) float32 mask.  Train mode (``.train()``) uses
        batch statistics, updates the running stats and applies Dropout2d.
        """
        cfg = self.cfg
        x = mix.to(torch.float32)[:, None]  # NCHW (B, 1, F, T)
        remat = cfg.remat and torch.is_grad_enabled()

        def run(level, *args):
            if remat:
                return checkpoint(level, *args, use_reentrant=False)
            return level(*args)

        skips = []
        for i in range(1, 7):
            x, new_mean, new_var = run(self._enc_level, i, x, weight, mesh)
            if self.training:
                getattr(self, f"conv{i}")[1].update(new_mean, new_var)
            skips.append(x)
        for i in range(1, 7):
            inp = skips[5] if i == 1 else torch.cat([x, skips[6 - i]], dim=1)
            if i == 6:  # the last deconv: no BN, ReLU or dropout
                x = self._deconv(6, inp)
                break
            keep = None
            if self.training:
                b = inp.shape[0]
                shape = (b * mesh.size if mesh is not None else b,
                         getattr(self, f"deconv{i}").weight.shape[1])
                keep = dropout_keep(shape, cfg.dropout_rate, inp.device,
                                    generator)
                if mesh is not None:
                    keep = keep[mesh.rank * b:(mesh.rank + 1) * b]
            x, new_mean, new_var = run(self._dec_level, i, inp, weight, keep,
                                       mesh)
            if self.training:
                getattr(self, f"deconv{i}_BAD")[0].update(new_mean, new_var)
        return torch.sigmoid(x.to(torch.float32))[:, 0]

    def _enc_level(self, i: int, x: torch.Tensor,
                   weight: Optional[torch.Tensor],
                   mesh: Optional[Mesh] = None):
        """Encoder level i: conv s2 -> BN -> LeakyReLU (reference model.py:
        42-77); returns the activation and BN's new running statistics."""
        cfg = self.cfg
        cd = torch_dtype(cfg.compute_dtype)
        conv, bn = getattr(self, f"conv{i}")
        x = (F.conv2d(x.to(cd), conv.weight.to(cd), None, conv.stride,
                      conv.padding)
             + conv.bias.to(cd)[None, :, None, None])
        x, new_mean, new_var = batch_norm(
            x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
            train=self.training, eps=bn.eps, momentum=bn.momentum,
            weight=weight, group=mesh)
        return (torch.where(x >= 0, x, cfg.leaky_slope * x),  # LeakyReLU
                new_mean, new_var)

    def _deconv(self, i: int, inp: torch.Tensor) -> torch.Tensor:
        cd = torch_dtype(self.cfg.compute_dtype)
        deconv = getattr(self, f"deconv{i}")
        return (F.conv_transpose2d(inp.to(cd), deconv.weight.to(cd), None,
                                   deconv.stride, deconv.padding,
                                   deconv.output_padding)
                + deconv.bias.to(cd)[None, :, None, None])

    def _dec_level(self, i: int, inp: torch.Tensor,
                   weight: Optional[torch.Tensor],
                   keep: Optional[torch.Tensor],
                   mesh: Optional[Mesh] = None):
        """Decoder level i < 6: deconv -> BN -> ReLU -> Dropout2d with the
        keep mask ``keep`` (train mode) (reference model.py:79-109)."""
        bn = getattr(self, f"deconv{i}_BAD")[0]
        x, new_mean, new_var = batch_norm(
            self._deconv(i, inp), bn.weight, bn.bias, bn.running_mean,
            bn.running_var, train=self.training, eps=bn.eps,
            momentum=bn.momentum, weight=weight, group=mesh)
        # ReLU as jnp.maximum(x, 0): the gradient at an exact 0 is 0.5, as
        # JAX's (torch.clamp gives 1 there, torch.relu 0)
        x = torch.maximum(x, torch.zeros_like(x))
        if keep is not None:
            x = dropout2d(x, self.cfg.dropout_rate, keep=keep)
        return x, new_mean, new_var


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

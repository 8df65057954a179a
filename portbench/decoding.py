"""What the decode cells share: the catalogue of seeded songs, the seeded
eval-mode model, the sample of answers that ``correct`` reads, and the
comparison of those answers with the reference's separation."""

from __future__ import annotations

import gc
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import compare, flops, songs, weights
from portbench.reference import decode as ref_decode, precision, unet

# the comparison's block of audio, seconds: at 5 s the program's worst
# block reads 0.0030-0.0091 and the control's 0.032-0.086 over 20 seeds
# (1 s: 0.0037-0.0129 against 0.040-0.106; H100, PERF.md)
BLOCK_S = 5.0
LIMITS = ("vocal_err",)


class Sample:
    """A uniform sample of ``k`` answers among all the window's answers,
    drawn from ``seed`` (reservoir sampling); thread-safe."""

    def __init__(self, k: int, seed: int):
        self.k, self.n = k, 0
        self.rng = np.random.default_rng(seed)
        self.kept: List[Tuple[int, np.ndarray]] = []
        self._lock = threading.Lock()

    def offer(self, song: int, answer: np.ndarray) -> None:
        with self._lock:
            if self.n < self.k:
                self.kept.append((song, answer))
            else:
                j = int(self.rng.integers(0, self.n + 1))
                if j < self.k:
                    self.kept[j] = (song, answer)
            self.n += 1


class Catalogue:
    """The cell's songs, its seeded weights (BatchNorm calibrated on the
    first song's segments) and the program's model holding them."""

    def __init__(self, ctx, pcm16: bool):
        from svs_torch.models.unet import UNet

        cfg, dev = ctx.config, ctx.device
        p = ctx.cell.params
        self.ctx, self.pcm16 = ctx, pcm16
        self.n = int(round(cfg["sample_rate"] * p["song_seconds"]))
        self.songs = [songs.mixture(ctx.derive("song", i), self.n,
                                    cfg["sample_rate"], dev, pcm16)
                      for i in range(cfg["catalogue_songs"])]
        params = weights.make(ctx.derive("weights"), cfg["enc_channels"],
                              dev)
        with precision.exact():
            weights.calibrate(params, ref_decode.segments_of(
                self.songs[0], cfg, dev), cfg["bn_eps"])
        self.params = {k: v.cpu() for k, v in params.items()}
        model = UNet(ctx.svs).to(dev)
        weights.load_into(model, params)
        self.model = model.eval()
        self.song_flops = (ref_decode.segments(self.n, cfg)
                           * flops.for_config(cfg)["forward"])

    def release(self) -> None:
        from svs_torch.infer import graphs
        self.model = None
        graphs.CACHE.clear()
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def references(self, wanted, conv=unet.conv_f32) -> Dict[int, np.ndarray]:
        dev = self.ctx.device
        params = {k: v.to(dev) for k, v in self.params.items()}
        with precision.exact():
            return {i: ref_decode.separate(params, self.songs[i],
                                           self.ctx.config, dev, conv)
                    for i in sorted(set(wanted))}

    def errors(self, answers: List[Tuple[int, np.ndarray]],
               refs: Dict[int, np.ndarray]) -> Dict[str, float]:
        """``vocal_err``: the worst block's relative error over the answers
        (int16 answers compared as PCM values; blocks of :data:`BLOCK_S`)."""
        block = int(BLOCK_S * self.ctx.config["sample_rate"])
        return {"vocal_err": max(compare.block_error(a, refs[i], block)
                                 for i, a in answers)}

    def readings(self, sample: Sample) -> Dict[str, float]:
        if not sample.kept:
            return {"vocal_err": float("inf")}
        refs = self.references(i for i, _ in sample.kept)
        return self.errors(sample.kept, refs)

    def control(self, k: int) -> Dict[str, float]:
        """The control's reading: the reference with fp8 convs in the
        program's place, over the first ``k`` songs."""
        wanted = range(min(k, len(self.songs)))
        refs = self.references(wanted)
        low = self.references(wanted, precision.conv_fp8)
        return self.errors(sorted(low.items()), refs)

"""Catalogue traffic: a library of songs separated in bursts, closed loop.

Set-up makes the configuration's ``catalogue_songs`` seeded mono songs of
``song_seconds`` at its rate (int16 PCM with ``pcm16``), the seeded eval-mode
model, and runs one burst (the program is built and captured there).  The
window calls ``separate_wav_stream(model, burst, pcm16=...)`` with
``burst`` songs of the catalogue, cycled, back to back, until the host
clock passes the window's seconds; each call returns the separated songs
to the host, so the window ends with the card idle.

``correct`` compares a seeded sample of ``check_sample`` of the window's
answers with the reference's separation of the same songs.
"""

from __future__ import annotations

import time
from typing import Dict

from portbench.decoding import LIMITS, Catalogue, Sample  # noqa: F401
from portbench.trace import span

PARAMS = {"song_seconds": float, "burst": int, "pcm16": bool,
          "check_sample": int}
CONFIG_KEYS = ("catalogue_songs",)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.cell.params
        self.cat = None

    def _call(self, first: int):
        from svs_torch.infer.separate import separate_wav_stream

        ids = [(first + j) % len(self.cat.songs)
               for j in range(self.p["burst"])]
        with span("stream_call"):
            outs = separate_wav_stream(self.cat.model,
                                       [self.cat.songs[i] for i in ids],
                                       pcm16=self.p["pcm16"],
                                       device=self.ctx.device)
        return ids, outs

    def setup(self) -> None:
        self.cat = Catalogue(self.ctx, self.p["pcm16"])
        self._call(0)
        self.sample = Sample(self.p["check_sample"],
                             self.ctx.derive("sample"))

    def window(self, seconds: float) -> Dict:
        done = 0
        t0 = time.perf_counter()
        while True:
            ids, outs = self._call(done)
            for i, out in zip(ids, outs):
                self.sample.offer(i, out)
            done += len(ids)
            if time.perf_counter() - t0 >= seconds:
                break
        secs = time.perf_counter() - t0
        return {"seconds": secs, "attempted": done, "failed": 0,
                "songs": done, "decode_flops_per_song": self.cat.song_flops,
                "e2e": {"audio_s_per_s":
                        done * self.p["song_seconds"] / secs}}

    def release(self) -> None:
        self.cat.release()

    def close(self) -> None:
        pass

    def check(self) -> Dict[str, float]:
        return self.cat.readings(self.sample)

    def control(self) -> Dict[str, float]:
        return self.cat.control(self.p["check_sample"])

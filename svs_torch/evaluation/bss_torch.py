"""BSS Eval (SDR / SIR / SAR) as one batched torch program, on the card in
float64 (port of ``svs_tpu/evaluation/bss_jax.py``).

The same BSS Eval v3 decomposition as :mod:`svs_torch.evaluation.bss` (the
numpy reference, a copy of svs_tpu's), computed the way svs_tpu's jitted
core computes it (bss_jax.py:54-127):

- all FFTs are shared (``torch.fft.rfft``): the references' spectra feed
  the Gram matrix, the cross-correlations and the projections;
- every (estimate, true source) pair is solved at once: the single-source
  systems in one batched ``torch.linalg.solve``, the all-sources system in
  one multi-right-hand-side solve;
- the energies come off the frequency-domain projections, so the metric
  matrices are one device computation and three small planes come back.

Signals are zero-padded to ``_bucket_len`` (the largest length that keeps
the FFT size), which changes no metric: every sum BSS eval takes is over
the signals' support, and n_fft >= T + flen - 1 keeps the correlations
linear.

Precision: float64 on every device.  svs_tpu's TPU default was float32
because the TPU has no native f64 (bss_jax.py:129-134); the H100 has, so
the card computes what the host reference computes.  A NaN in the result
(an ill-conditioned Gram matrix) makes that call fall back to the numpy
reference (as does an exactly singular solve), with a logged warning and a
count in :data:`fallbacks`, so a fallback never passes unseen.  These FFTs and solves are library calls in
the place of XLA's ops; no TPU kernel computes this function.
"""

from __future__ import annotations

import itertools
import logging
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from svs_torch.evaluation import bss as _bss_np
from svs_torch.utils.device import DeviceLike, resolve_device

FLEN = _bss_np.FLEN

log = logging.getLogger(__name__)

# calls that fell back to the numpy reference
fallbacks = 0


def _metric_matrices(refs: torch.Tensor, ests: torch.Tensor, flen: int):
    """(nsrc, Tp) padded refs/ests -> (sdr, sir, sar) matrices (nsrc, nsrc)
    indexed [jest, jtrue] (bss.py:31-94 through the identities

        s_filt             = proj(ref_jtrue, est_jest)      "single"
        s_filt + e_interf  = proj(all refs,  est_jest)      "all"
        e_interf + e_artif = est - single,   e_artif = est - all

    so only the two projections are formed)."""
    nsrc, tp = refs.shape
    dev = refs.device
    n_fft = int(2 ** math.ceil(math.log2(tp + flen - 1)))

    sf = torch.fft.rfft(refs, n=n_fft, dim=1)                   # (nsrc, F)
    ef = torch.fft.rfft(ests, n=n_fft, dim=1)

    # Gram blocks of the delayed references: circular correlations
    ss = torch.fft.irfft(sf[:, None] * sf[None].conj(), n=n_fft, dim=-1)
    taps = torch.arange(flen, device=dev)
    lag = (taps[None, :] - taps[:, None]) % n_fft
    g_blocks = ss[:, :, lag]                                    # [i, j, a, b]
    g_full = g_blocks.permute(0, 2, 1, 3).reshape(nsrc * flen, nsrc * flen)

    # cross-correlations estimate <-> delayed references (bss.py:55-58)
    sse = torch.fft.irfft(sf[None] * ef[:, None].conj(), n=n_fft, dim=-1)
    d = sse[:, :, (-taps) % n_fft]                              # [jest, i, a]

    # all-references projection filters: one multi-RHS solve (bss.py:61)
    c_all = torch.linalg.solve(g_full, d.reshape(nsrc, nsrc * flen).T)
    c_all = c_all.T.reshape(nsrc, nsrc, flen)                   # [jest, i, a]
    proj_all = torch.fft.irfft(
        (torch.fft.rfft(c_all, n=n_fft, dim=-1) * sf[None]).sum(dim=1),
        n=n_fft, dim=-1)                                        # [jest, n]

    # single-reference projections: batched over jtrue, multi-RHS over jest
    src = torch.arange(nsrc, device=dev)
    c_single = torch.linalg.solve(g_blocks[src, src], d.permute(1, 2, 0))
    c_single = c_single.permute(2, 0, 1)                        # [jest, jtrue, a]
    proj_single = torch.fft.irfft(
        torch.fft.rfft(c_single, n=n_fft, dim=-1) * sf[None],
        n=n_fft, dim=-1)                                        # [jest, jtrue, n]

    est_full = F.pad(ests, (0, n_fft - tp))
    e_single = (proj_single ** 2).sum(dim=-1)
    e_all = (proj_all ** 2).sum(dim=-1)
    e_resid = ((est_full[:, None] - proj_single) ** 2).sum(dim=-1)
    e_interf = ((proj_all[:, None] - proj_single) ** 2).sum(dim=-1)
    e_artif = ((est_full - proj_all) ** 2).sum(dim=-1)

    tiny = torch.finfo(refs.dtype).tiny

    def db(ratio):
        return 10.0 * torch.log10(ratio + tiny)

    sdr = db(e_single / e_resid)
    sir = db(e_single / e_interf)
    sar = db(e_all / e_artif)[:, None].expand(nsrc, nsrc)
    return sdr, sir, sar


def _bucket_len(nsampl: int, flen: int) -> int:
    """The padded length: the largest T' with this T's FFT size."""
    n_fft = int(2 ** math.ceil(math.log2(nsampl + flen - 1)))
    return n_fft - flen + 1


def _run_core(refs: np.ndarray, ests: np.ndarray, flen: int,
              device: torch.device):
    nsrc, nsampl = refs.shape
    tp = _bucket_len(nsampl, flen)
    pad = ((0, 0), (0, tp - nsampl))

    def put(a):
        return torch.from_numpy(np.pad(a, pad)).to(device)

    with torch.no_grad():
        mats = _metric_matrices(put(refs), put(ests), flen)
    return tuple(m.cpu().numpy() for m in mats)


def bss_eval_sources(reference_sources: np.ndarray,
                     estimated_sources: np.ndarray,
                     compute_permutation: bool = True, *,
                     device: DeviceLike = None):
    """:func:`svs_torch.evaluation.bss.bss_eval_sources` on ``device``
    (``cuda`` unless the caller asks for the CPU): the same validation,
    permutation rule (max mean SIR) and return contract; a NaN result falls
    back to the numpy reference for this call, with a warning."""
    global fallbacks
    refs = np.atleast_2d(np.asarray(reference_sources, np.float64))
    ests = np.atleast_2d(np.asarray(estimated_sources, np.float64))
    if refs.shape != ests.shape:
        raise ValueError("reference and estimated shapes differ: "
                         f"{refs.shape} vs {ests.shape}")
    for name, arr in (("reference", refs), ("estimated", ests)):
        if np.any(np.all(arr == 0, axis=1)):
            raise ValueError(f"all-silent {name} source present; BSS eval is "
                             "undefined (matches mir_eval behaviour)")
    nsrc = refs.shape[0]

    try:
        sdr, sir, sar = _run_core(refs, ests, FLEN, resolve_device(device))
        # +inf is legitimate (zero interference); NaN means the solve broke
        broken = "NaN" if any(np.isnan(m).any() for m in (sdr, sir, sar)) \
            else None
    except torch.linalg.LinAlgError:  # an exactly singular Gram matrix
        broken = "a singular solve"
    if broken:
        fallbacks += 1
        log.warning("bss_torch: %s in the result on %s (%d sources, %d "
                    "samples); this call falls back to the numpy reference",
                    broken, device, nsrc, refs.shape[1])
        return _bss_np.bss_eval_sources(refs, ests, compute_permutation)

    if compute_permutation:
        perms = list(itertools.permutations(range(nsrc)))
        mean_sir = [np.mean([sir[p[k], k] for k in range(nsrc)])
                    for p in perms]
        popt = np.asarray(perms[int(np.argmax(mean_sir))])
        idx = (popt, np.arange(nsrc))
        return sdr[idx], sir[idx], sar[idx], popt
    diag = (np.arange(nsrc), np.arange(nsrc))
    return sdr[diag], sir[diag], sar[diag], np.arange(nsrc)


def compute_metrics_for_track(mix: np.ndarray, vocal_ref: np.ndarray,
                              vocal_est: np.ndarray, *,
                              device: DeviceLike = None) -> Dict[str, float]:
    """:func:`svs_torch.evaluation.bss.compute_metrics_for_track` on the
    device (reference evaluate.py:26-84: the 2-source eval with the
    accompaniment as mix - vocal, NSDR = SDR(est) - SDR(mixture))."""
    min_len = min(len(mix), len(vocal_ref), len(vocal_est))
    mix = np.asarray(mix[:min_len], np.float64)
    vocal_ref = np.asarray(vocal_ref[:min_len], np.float64)
    vocal_est = np.asarray(vocal_est[:min_len], np.float64)

    refs = np.stack([vocal_ref, mix - vocal_ref])
    ests = np.stack([vocal_est, mix - vocal_est])
    sdr, sir, sar, perm = bss_eval_sources(refs, ests, device=device)
    vocal_idx = int(perm[0])  # evaluate.py:62

    sdr_mix, _, _, _ = bss_eval_sources(vocal_ref[None, :], mix[None, :],
                                        device=device)
    nsdr = float(sdr[vocal_idx]) - float(sdr_mix[0])  # evaluate.py:68-77
    return {"SDR": float(sdr[vocal_idx]), "SIR": float(sir[vocal_idx]),
            "SAR": float(sar[vocal_idx]), "NSDR": nsdr}

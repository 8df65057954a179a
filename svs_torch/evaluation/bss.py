"""BSS Eval source-separation metrics (SDR / SIR / SAR) + NSDR, host f64
(a copy of ``svs_tpu/evaluation/bss.py``: numpy and scipy, no torch).

The reference delegates to ``mir_eval.separation.bss_eval_sources``
(reference evaluate.py:58,74), which implements BSS Eval v3 (Vincent, Gribonval
& Fevotte, "Performance measurement in blind audio source separation", IEEE
TASLP 2006): each estimate is decomposed into a true-source part — the least-
squares projection onto 512-tap delayed versions of the matching reference —
plus interference (projection onto ALL references minus the true part) and
artifact residual.  This is an independent numpy implementation of that
published algorithm (mir_eval is not vendored or copied), host-side like the
reference since evaluation is offline.  It is the metric's reference in the
port: :mod:`svs_torch.evaluation.bss_torch` is held against it.

Conventions matched to mir_eval for metric parity:
- filter length 512
- permutation search maximising mean SIR (compute_permutation=True)
- silent reference/estimated sources raise ValueError
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import numpy as np
from scipy.linalg import toeplitz
from scipy.signal import fftconvolve

FLEN = 512


def _project(reference_sources: np.ndarray, estimated_source: np.ndarray,
             flen: int) -> np.ndarray:
    """Least-squares projection of ``estimated_source`` onto the subspace
    spanned by all ``flen``-sample delays of every reference source."""
    nsrc, nsampl = reference_sources.shape
    refs = np.hstack((reference_sources, np.zeros((nsrc, flen - 1))))
    est = np.hstack((estimated_source, np.zeros(flen - 1)))

    n_fft = int(2 ** np.ceil(np.log2(nsampl + flen - 1)))
    sf = np.fft.fft(refs, n=n_fft, axis=1)
    sef = np.fft.fft(est, n=n_fft)

    # Gram matrix of delayed references (block-Toeplitz, via circular
    # correlations)
    g = np.zeros((nsrc * flen, nsrc * flen))
    for i in range(nsrc):
        for j in range(i, nsrc):
            ssf = np.real(np.fft.ifft(sf[i] * np.conj(sf[j])))
            block = toeplitz(np.hstack((ssf[0], ssf[-1:-flen:-1])),
                             r=ssf[:flen])
            g[i * flen:(i + 1) * flen, j * flen:(j + 1) * flen] = block
            g[j * flen:(j + 1) * flen, i * flen:(i + 1) * flen] = block.T

    # cross-correlations estimate <-> delayed references
    d = np.zeros(nsrc * flen)
    for i in range(nsrc):
        ssef = np.real(np.fft.ifft(sf[i] * np.conj(sef)))
        d[i * flen:(i + 1) * flen] = np.hstack((ssef[0], ssef[-1:-flen:-1]))

    try:
        c = np.linalg.solve(g, d).reshape(flen, nsrc, order="F")
    except np.linalg.LinAlgError:
        c = np.linalg.lstsq(g, d, rcond=None)[0].reshape(flen, nsrc,
                                                         order="F")

    sproj = np.zeros(nsampl + flen - 1)
    for i in range(nsrc):
        sproj += fftconvolve(c[:, i], refs[i])[: nsampl + flen - 1]
    return sproj


def _decompose(reference_sources: np.ndarray, estimated_source: np.ndarray,
               j: int, flen: int):
    """s_true / e_spat / e_interf / e_artif decomposition (bss_eval_sources
    variant: the true part allows a flen-tap filter of reference j)."""
    nsampl = estimated_source.shape[0]
    s_true = np.hstack((reference_sources[j], np.zeros(flen - 1)))
    e_spat = _project(reference_sources[j][np.newaxis, :], estimated_source,
                      flen) - s_true
    e_interf = _project(reference_sources, estimated_source, flen) \
        - s_true - e_spat
    e_artif = -s_true - e_spat - e_interf
    e_artif[:nsampl] += estimated_source
    return s_true, e_spat, e_interf, e_artif


def _crit(s_true, e_spat, e_interf, e_artif) -> Tuple[float, float, float]:
    s_filt = s_true + e_spat
    # zero interference (e.g. single-source eval) legitimately yields inf SIR
    with np.errstate(divide="ignore"):
        sdr = _db(np.sum(s_filt ** 2) / np.sum((e_interf + e_artif) ** 2))
        sir = _db(np.sum(s_filt ** 2) / np.sum(e_interf ** 2))
        sar = _db(np.sum((s_filt + e_interf) ** 2) / np.sum(e_artif ** 2))
    return sdr, sir, sar


def _db(ratio: float) -> float:
    return float(10.0 * np.log10(ratio + np.finfo(np.float64).tiny))


def bss_eval_sources(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    compute_permutation: bool = True,
):
    """(nsrc, T) refs + ests -> (sdr, sir, sar, perm) arrays of shape (nsrc,).

    ``perm[k]`` is the estimate index assigned to reference k when
    ``compute_permutation`` (chosen to maximise mean SIR); otherwise identity.
    """
    reference_sources = np.atleast_2d(np.asarray(reference_sources,
                                                 np.float64))
    estimated_sources = np.atleast_2d(np.asarray(estimated_sources,
                                                 np.float64))
    if reference_sources.shape != estimated_sources.shape:
        raise ValueError("reference and estimated shapes differ: "
                         f"{reference_sources.shape} vs "
                         f"{estimated_sources.shape}")
    nsrc = reference_sources.shape[0]
    for name, arr in (("reference", reference_sources),
                      ("estimated", estimated_sources)):
        if np.any(np.all(arr == 0, axis=1)):
            raise ValueError(f"all-silent {name} source present; BSS eval is "
                             "undefined (matches mir_eval behaviour)")

    if compute_permutation:
        sdr = np.empty((nsrc, nsrc))
        sir = np.empty((nsrc, nsrc))
        sar = np.empty((nsrc, nsrc))
        for jest in range(nsrc):
            for jtrue in range(nsrc):
                parts = _decompose(reference_sources,
                                   estimated_sources[jest], jtrue, FLEN)
                sdr[jest, jtrue], sir[jest, jtrue], sar[jest, jtrue] = \
                    _crit(*parts)
        perms = list(itertools.permutations(range(nsrc)))
        mean_sir = [np.mean([sir[p[k], k] for k in range(nsrc)])
                    for p in perms]
        popt = np.asarray(perms[int(np.argmax(mean_sir))])
        idx = (popt, np.arange(nsrc))
        return sdr[idx], sir[idx], sar[idx], popt
    else:
        out_sdr = np.empty(nsrc)
        out_sir = np.empty(nsrc)
        out_sar = np.empty(nsrc)
        for j in range(nsrc):
            parts = _decompose(reference_sources, estimated_sources[j], j,
                               FLEN)
            out_sdr[j], out_sir[j], out_sar[j] = _crit(*parts)
        return out_sdr, out_sir, out_sar, np.arange(nsrc)


def compute_metrics_for_track(
    mix: np.ndarray, vocal_ref: np.ndarray, vocal_est: np.ndarray
) -> Dict[str, float]:
    """Reference evaluate.py:26-84 semantics: 2-source eval with
    accompaniment approximated as mix - vocal, plus NSDR = SDR(est) -
    SDR(mixture-as-estimate)."""
    min_len = min(len(mix), len(vocal_ref), len(vocal_est))
    mix = np.asarray(mix[:min_len], np.float64)
    vocal_ref = np.asarray(vocal_ref[:min_len], np.float64)
    vocal_est = np.asarray(vocal_est[:min_len], np.float64)

    refs = np.stack([vocal_ref, mix - vocal_ref])
    ests = np.stack([vocal_est, mix - vocal_est])
    sdr, sir, sar, perm = bss_eval_sources(refs, ests)
    vocal_idx = int(perm[0])  # evaluate.py:62

    sdr_mix, _, _, _ = bss_eval_sources(vocal_ref[None, :], mix[None, :])
    nsdr = float(sdr[vocal_idx]) - float(sdr_mix[0])  # evaluate.py:68-77

    return {
        "SDR": float(sdr[vocal_idx]),
        "SIR": float(sir[vocal_idx]),
        "SAR": float(sar[vocal_idx]),
        "NSDR": nsdr,
    }

// The STFT front ends' epilogue, shared by the three routes (stft_fft.cu,
// stft_mixed.cu and stft_magphase.cu), so that the magnitude of stft_magnitude is the same
// bits as stft_magphase's: |X| and, with kPhase, the unit phase of one bin
// of one frame, as svs_tpu/ops/pallas/dsp.py:165-174 computes them.
#pragma once

namespace {

template <bool kPhase>
__device__ __forceinline__ void store_bin(float* mag, float* pre, float* pim,
                                          long long o, float r, float q) {
  const float m = sqrtf(r * r + q * q);
  if constexpr (!kPhase) {
    mag[o] = m;
    return;
  }
  // the threshold (not > 0) keeps subnormal magnitudes in the 1+0j branch,
  // where 1/mag would overflow (as dsp.py:166-174)
  const bool nz = m > 1e-30f;
  const float inv = nz ? 1.0f / m : 0.0f;
  mag[o] = m;
  pre[o] = nz ? r * inv : 1.0f;
  pim[o] = q * inv;
}

}  // namespace

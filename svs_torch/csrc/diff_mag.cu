// spectral_mag for Hopper (sm_90a): the differentiable |STFT| of the
// MR-STFT loss, forward and backward.
//
// Replaces the TPU kernel svs_tpu/ops/pallas/diff_mag.py::spectral_mag
// (forward _fwd_kernel, backward _bwd_kernel).  The GEMMs and their
// epilogues are in spectral_gemm.cuh; the wrapper, the plain PyTorch
// version and the launch counters in svs_torch/ops/cuda/diff_mag.py.
//
// Bounds on an H100 SXM at the train step's shapes (B = 32, 97,536
// samples, a call per resolution): the function's least work is its bytes,
// 12.5 MB of signal read and 53-64 MB of magnitude written, 20-23 us a
// forward call; the window-deep GEMM here, on dense bf16 tensor cores,
// 23-66 us.  The backward is the same GEMM plus the transposed one, each
// as deep.

#include "spectral_gemm.cuh"

using namespace spec;

// C entry points for ctypes.  Pointers are device pointers; ``x`` points at
// the padded bf16 signal's first kernel tap (see spectral.py); ``taps`` is
// the (n_cols, n_taps) basis.  Each launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
extern "C" int svs_spectral_mag_fwd(const void* x, long long stride,
                                    int batch, const void* taps, int n_taps,
                                    int n_cols, int hop, int n_frames,
                                    int n_bins, void* mag, void* stream) {
  if (!gemm_shape_ok(stride, batch, n_taps, n_cols, hop, n_frames, n_bins))
    return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.stride = stride;
  a.taps = static_cast<const bf16*>(taps);
  a.n_taps = n_taps;
  a.n_cols = n_cols;
  a.hop = hop;
  a.n_frames = n_frames;
  a.n_bins = n_bins;
  a.mag = static_cast<float*>(mag);
  return launch_fwd<1, kMag>(a, batch, (cudaStream_t)stream);
}

// The backward: the (B, n_bins, n_frames) magnitude cotangent ``g`` ->
// the bf16 column cotangent ``g_cols`` (B, n_frames, n_cols) -> ``out``
// (B, rows, hop), the cotangent of the padded signal in hop-wide rows.
extern "C" int svs_spectral_mag_bwd(const void* x, long long stride,
                                    int batch, const void* taps, int n_taps,
                                    int n_cols, int hop, int n_frames,
                                    int n_bins, const void* g, void* g_cols,
                                    const void* shifts, int k, int hop_pad,
                                    int left, int win, void* out,
                                    void* stream) {
  if (!gemm_shape_ok(stride, batch, n_taps, n_cols, hop, n_frames, n_bins))
    return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.stride = stride;
  a.taps = static_cast<const bf16*>(taps);
  a.n_taps = n_taps;
  a.n_cols = n_cols;
  a.hop = hop;
  a.n_frames = n_frames;
  a.n_bins = n_bins;
  a.g = static_cast<const float*>(g);
  a.g_cols = static_cast<bf16*>(g_cols);
  const int rc = launch_fwd<1, kGradMag>(a, batch, (cudaStream_t)stream);
  if (rc != 0) return rc;
  AdjArgs d = {static_cast<const bf16*>(g_cols),
               static_cast<const bf16*>(shifts),
               static_cast<float*>(out),
               n_frames, n_cols, hop, hop_pad, k, n_frames + k - 1, left,
               win};
  return launch_adjoint(d, batch, (cudaStream_t)stream);
}

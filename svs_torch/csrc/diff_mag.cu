// spectral_mag for Hopper (sm_90a): the differentiable |STFT| of the
// MR-STFT loss, forward and backward.
//
// Replaces the TPU kernel svs_tpu/ops/pallas/diff_mag.py::spectral_mag
// (forward _fwd_kernel, backward _bwd_kernel).  Both directions run the
// wgmma DFT GEMM of spectral.cuh over one staged signal span a frame tile:
// the forward with the kMagFwd epilogue, which writes |X| through shared
// memory as whole rows of frames; the backward with kMagGrad, which writes
// the bf16 column cotangent, then the adjoint.  The wrapper, the plain
// PyTorch version and the launch counters are in
// svs_torch/ops/cuda/diff_mag.py.
//
// Bounds on an H100 SXM at the train step's shapes (B = 32, 97,536
// samples, a call per resolution): the function's least work is its bytes,
// 12.5 MB of signal read and 53-64 MB of magnitude written, 20-23 us a
// forward call; the window-deep GEMM here (64-tap stages), on dense bf16
// tensor cores, 23-66 us.  The backward is that GEMM again plus the
// adjoint's hop-wide one over the shifts that meet the window: 38-145 us
// (spectral.cuh).

#include "spectral.cuh"

using namespace spec;

// C entry points for ctypes.  Pointers are device pointers; ``x`` points at
// the padded bf16 signal's first tap (see spectral.py), ``row_len`` samples
// readable from there in each row; ``tiles`` is the pre-tiled basis
// (spectral.dft_tiles).  Each launches on ``stream`` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernels do not take.
extern "C" int svs_spectral_mag_fwd(const void* x, long long stride,
                                    int batch, int row_len, const void* tiles,
                                    int n_taps, int n_cols, int hop,
                                    int n_frames, int n_bins, void* mag,
                                    void* stream) {
  DftArgs a = dft_args(x, x, stride, row_len, tiles, n_taps, n_cols, hop,
                       n_frames);
  if (n_bins != a.n_bins) return (int)cudaErrorInvalidValue;
  a.out = static_cast<float*>(mag);
  return launch_dft<1, kMagFwd>(a, batch, (cudaStream_t)stream);
}

// The backward: the (B, n_bins, n_frames) magnitude cotangent ``g`` ->
// the bf16 column cotangent ``g_cols`` (B, n_frames, n_cols) -> ``out``
// (B, rows, hop), the cotangent of the padded signal in hop-wide rows.
// ``shifts`` are the adjoint's pre-tiled bases (spectral.shift_tiles), the
// shifts j_lo .. j_lo + k - 1 in hop tiles of ``width``.
extern "C" int svs_spectral_mag_bwd(const void* x, long long stride,
                                    int batch, int row_len, const void* tiles,
                                    int n_taps, int n_cols, int hop,
                                    int n_frames, int n_bins, const void* g,
                                    void* g_cols, const void* shifts, int k,
                                    int j_lo, int width, void* out,
                                    void* stream) {
  DftArgs a = dft_args(x, x, stride, row_len, tiles, n_taps, n_cols, hop,
                       n_frames);
  if (n_bins != a.n_bins) return (int)cudaErrorInvalidValue;
  a.g = static_cast<const float*>(g);
  a.g_cols = static_cast<bf16*>(g_cols);
  const int rc = launch_dft<1, kMagGrad>(a, batch, (cudaStream_t)stream);
  if (rc != 0) return rc;
  AdjArgs d = {static_cast<const bf16*>(g_cols),
               static_cast<const bf16*>(shifts),
               static_cast<float*>(out),
               n_frames, n_cols, hop, k, j_lo,
               n_frames + cdiv(n_cols, hop) - 1};
  return launch_adjoint(d, width, batch, (cudaStream_t)stream);
}

// The shared memory a block asks for, in bytes: the DFT GEMM's with
// ``nsig`` signal spans, and the adjoint's with hop tiles of ``width`` and
// ``k`` shifts; spectral.py's mirror of these sizes is held against them.
extern "C" int svs_dft_smem(int nsig, int hop, int n_taps) {
  return dft_smem(nsig, dft_span(hop, n_taps));
}

extern "C" int svs_adj_smem(int width, int k) { return adj_smem(width, k); }

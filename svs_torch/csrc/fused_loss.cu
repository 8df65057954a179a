// loss_partials for Hopper (sm_90a): the reduction-fused MR-STFT loss,
// forward and backward.
//
// Replaces the TPU kernel svs_tpu/ops/pallas/fused_loss.py::loss_partials
// (forward _fwd_kernel / _fwd_kernel_wide, backward _bwd_kernel /
// _bwd_kernel_wide; ``wide`` is a TPU lane layout of the same numbers and
// runs these same kernels).  Both directions run the wgmma DFT GEMM of
// spectral.cuh over the staged spans of x and y, the two sharing each
// basis stage: the forward with the kLossFwd epilogue, which reduces the
// block's cells to three sums in a fixed order; the backward with
// kLossGrad, which writes the bf16 column cotangent of x, then the
// adjoint.  The wrapper, the plain PyTorch version and the launch counters
// are in svs_torch/ops/cuda/fused_loss.py.
//
// Bounds on an H100 SXM at the train step's shapes (B = 32, 97,536
// samples, a call per resolution): the function's least work is the real
// FFTs of x and y at the float32 rate (it accumulates in float32), 23-25 us
// a forward call and 35-38 us a backward, above the 7.5 us of reading x and
// y; the window-deep GEMMs here (64-tap stages), on dense bf16 tensor
// cores, 33-131 us a forward call; the backward's (two DFTs and the
// adjoint, spectral.cuh) 55-210 us.  The forward writes nothing frame- or
// bin-shaped: each block leaves three sums.

#include "spectral.cuh"

using namespace spec;

// C entry points for ctypes.  ``x`` and ``y`` point at the padded bf16
// signals' first taps (see spectral.py), ``row_len`` samples readable from
// there in each row; ``tiles`` is the pre-tiled basis (spectral.dft_tiles),
// ``n_cols`` columns: the bins' pairs of ``n_fft`` padded to whole 128-column
// tiles; ``partials`` is (B, ceil(n_frames / 64), n_cols / 128, 3).  Each launches
// on ``stream`` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int svs_loss_partials_fwd(const void* x, const void* y,
                                     long long stride, int batch, int row_len,
                                     const void* tiles, int n_taps, int n_cols,
                                     int n_fft, int hop, int n_frames,
                                     void* partials, void* stream) {
  DftArgs a = dft_args(x, y, stride, row_len, tiles, n_taps, n_cols, n_fft,
                       hop, n_frames);
  a.out = static_cast<float*>(partials);
  return launch_dft<2, kLossFwd>(a, batch, (cudaStream_t)stream);
}

// The backward: the (B, 3) cotangent ``g`` of the partials -> the bf16
// column cotangent of x ``g_cols`` (B, n_frames, n_cols) -> ``out``
// (B, rows, hop), the cotangent of x's padded signal in hop-wide rows; the
// rest as svs_spectral_mag_bwd (diff_mag.cu).
extern "C" int svs_loss_partials_bwd(const void* x, const void* y,
                                     long long stride, int batch, int row_len,
                                     const void* tiles, int n_taps, int n_cols,
                                     int n_fft, int hop, int n_frames,
                                     const void* g, void* g_cols, const void* shifts, int k,
                                     int j_lo, int width, void* out,
                                     void* stream) {
  DftArgs a = dft_args(x, y, stride, row_len, tiles, n_taps, n_cols, n_fft,
                       hop, n_frames);
  a.g = static_cast<const float*>(g);
  a.g_cols = static_cast<bf16*>(g_cols);
  const int rc = launch_dft<2, kLossGrad>(a, batch, (cudaStream_t)stream);
  if (rc != 0) return rc;
  AdjArgs d = {static_cast<const bf16*>(g_cols),
               static_cast<const bf16*>(shifts),
               static_cast<float*>(out),
               n_frames, n_cols, hop, k, j_lo,
               n_frames + cdiv(n_fft, hop) - 1};
  return launch_adjoint(d, width, batch, (cudaStream_t)stream);
}

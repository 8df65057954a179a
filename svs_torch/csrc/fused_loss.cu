// loss_partials for Hopper (sm_90a): the reduction-fused MR-STFT loss,
// forward and backward.
//
// Replaces the TPU kernel svs_tpu/ops/pallas/fused_loss.py::loss_partials
// (forward _fwd_kernel / _fwd_kernel_wide, backward _bwd_kernel /
// _bwd_kernel_wide; ``wide`` is a TPU lane layout of the same numbers and
// runs these same kernels).  The GEMMs and their epilogues are in
// spectral_gemm.cuh (forward) and spectral_bwd.cuh (backward, on wgmma);
// the wrapper, the plain PyTorch version and the launch counters in
// svs_torch/ops/cuda/fused_loss.py.
//
// Bounds on an H100 SXM at the train step's shapes (B = 32, 97,536
// samples, a call per resolution): the function's least work is the real
// FFTs of x and y at the float32 rate (it accumulates in float32), 23-25 us
// a forward call and 35-38 us a backward, above the 7.5 us of reading x and
// y; the window-deep GEMMs here, on dense bf16 tensor cores, 33-131 us a
// forward call; the backward's (two DFTs and the adjoint, spectral_bwd.cuh)
// 55-210 us.  The forward writes nothing frame- or bin-shaped: each
// block leaves three sums.

#include "spectral_bwd.cuh"

using namespace spec;

namespace {

FwdArgs pair_args(const void* x, const void* y, long long stride,
                  const void* taps, int n_taps, int n_cols, int hop,
                  int n_frames) {
  FwdArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<const bf16*>(y);
  a.stride = stride;
  a.taps = static_cast<const bf16*>(taps);
  a.n_taps = n_taps;
  a.n_cols = n_cols;
  a.hop = hop;
  a.n_frames = n_frames;
  a.n_bins = n_cols / 2 + 1;
  return a;
}

}  // namespace

// C entry points for ctypes.  ``x`` and ``y`` point at the padded bf16
// signals' first kernel taps (see spectral.py); ``partials`` is
// (B, ceil(n_frames / 64), n_cols / 128, 3).  Each launches on ``stream``
// and returns cudaGetLastError() (0 on success).
extern "C" int svs_loss_partials_fwd(const void* x, const void* y,
                                     long long stride, int batch,
                                     const void* taps, int n_taps, int n_cols,
                                     int hop, int n_frames, void* partials,
                                     void* stream) {
  if (!gemm_shape_ok(stride, batch, n_taps, n_cols, hop, n_frames,
                     n_cols / 2 + 1))
    return (int)cudaErrorInvalidValue;
  FwdArgs a = pair_args(x, y, stride, taps, n_taps, n_cols, hop, n_frames);
  a.partials = static_cast<float*>(partials);
  return launch_fwd<2, kPartials>(a, batch, (cudaStream_t)stream);
}

// The backward: the (B, 3) cotangent ``g`` of the partials -> the bf16
// column cotangent of x ``g_cols`` (B, n_frames, n_cols) -> ``out``
// (B, rows, hop), the cotangent of x's padded signal in hop-wide rows.
// ``x`` and ``y`` point at the padded signals' first backward tap; the
// rest as svs_spectral_mag_bwd (diff_mag.cu).
extern "C" int svs_loss_partials_bwd(const void* x, const void* y,
                                     long long stride, int batch, int row_len,
                                     const void* tiles, int n_taps, int n_cols,
                                     int hop, int n_frames, const void* g,
                                     void* g_cols, const void* shifts, int k,
                                     int j_lo, int width, void* out,
                                     void* stream) {
  bwd::GradArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<const bf16*>(y);
  a.stride = stride;
  a.row_len = row_len;
  a.tiles = static_cast<const bf16*>(tiles);
  a.n_taps = n_taps;
  a.n_cols = n_cols;
  a.hop = hop;
  a.n_frames = n_frames;
  a.n_bins = n_cols / 2 + 1;
  a.g = static_cast<const float*>(g);
  a.g_cols = static_cast<bf16*>(g_cols);
  const int rc = bwd::launch_grad<2, bwd::kGradLoss>(a, batch,
                                                     (cudaStream_t)stream);
  if (rc != 0) return rc;
  bwd::AdjArgs d = {static_cast<const bf16*>(g_cols),
                    static_cast<const bf16*>(shifts),
                    static_cast<float*>(out),
                    n_frames, n_cols, hop, k, j_lo,
                    n_frames + cdiv(n_cols, hop) - 1};
  return bwd::launch_adjoint(d, width, batch, (cudaStream_t)stream);
}

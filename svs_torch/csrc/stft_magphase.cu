// Fused STFT + magphase front end for Hopper (sm_90a), true float32.
//
// Replaces the TPU kernel svs_tpu/ops/pallas/dsp.py::stft_magphase
// (_stft_magphase_kernel): centre constant pad, periodic-hann windowed real
// DFT, magnitude, and the unit-phase real/imag planes with 1+0j where
// mag <= 1e-30 (librosa.magphase contract, reference data.py:80).
//
// Formulation: an implicit-framing GEMM.  With y the unpadded signal and
// p = n_fft/2 the centre pad,
//     A[f, n]   = y[f*hop + n - p]  (0 outside [0, n_samples))
//     C[f, col] = sum_n A[f, n] * basis[n, col]
// A is never written to memory: each block stages the signal samples of its
// frames straight from y, so the centre pad and the framing cost no pass.
// The basis (built on the host, uploaded once per n_fft) carries the window
// and rfft's sign, with the columns of each bin side by side: column 2b is
// the cosine of bin b and 2b+1 its negated sine, for 1 <= b < n_fft/2.  The
// sines of bin 0 and of the Nyquist bin n_fft/2 are zero, so their two
// cosines share the first pair: column 0 is bin 0, column 1 the Nyquist
// bin.  That fits the n_fft/2 + 1 bins in exactly n_fft columns.  The
// epilogue computes mag and the unit phase while re/im are in registers and
// stores straight into the (n_bins, n_frames) layout of the JAX kernel.
//
// Bound: at the decode shape (2,097,152 samples, 2,731 frames, n_fft 1024)
// the kernel does 2 * 2731 * 1024 * 1024 = 5.7 GFLOP of f32 FMA work and
// must move ~29 MB (signal, basis, three output planes), so it is bound by
// operations: ~86 us at the H100 SXM's 67 TFLOP/s of non-tensor f32 against
// ~9 us for the bytes at 3.35 TB/s.  It stays FFMA (Precision.HIGHEST on
// the TPU, dsp.py:72-79: no TF32) and goes after that bound as an SGEMM
// does: each thread keeps an 8 frames x 8 columns tile of accumulators and
// reads its operands as float4 (4 shared loads per 64 FMAs); the stages are
// double-buffered with cp.async, so the next 16 taps load while these are
// multiplied.  A 64-frame block tile gives the decode shape 344 blocks, ~2.6
// per SM.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;    // frames per block
constexpr int kBN = 128;   // basis columns per block (64 bins, re and im)
constexpr int kBK = 16;    // taps per shared-memory stage
constexpr int kTM = 8;     // frames per thread: two runs of 4
constexpr int kTN = 8;     // columns per thread: two runs of 4 (2 bins each)
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 128
// +4 floats of row pitch: the signal staging walks taps fastest, and a
// pitch of kBM would put a warp's 16 taps of one frame in one bank; a
// multiple of 4 keeps the float4 reads aligned
constexpr int kPitchA = kBM + 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte async copy; src_bytes 0 writes a zero (the centre pad and the
// frames past the end) without reading src
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store_bin(float* mag, float* pre, float* pim,
                                          long long o, float r, float q) {
  const float m = sqrtf(r * r + q * q);
  // the threshold (not > 0) keeps subnormal magnitudes in the 1+0j branch,
  // where 1/mag would overflow (as dsp.py:166-174)
  const bool nz = m > 1e-30f;
  const float inv = nz ? 1.0f / m : 0.0f;
  mag[o] = m;
  pre[o] = nz ? r * inv : 1.0f;
  pim[o] = q * inv;
}

// at least 3 blocks per SM: that leaves a thread up to 168 registers (it
// takes ~150); asking for 4 caps it at 128, and the tile spills
__global__ void __launch_bounds__(kThreads, 3)
stft_magphase_kernel(const float* __restrict__ y, long long n_samples,
                     const float* __restrict__ basis, int n_taps, int n_cols,
                     int hop, int pad, int n_bins, int n_frames,
                     float* __restrict__ mag, float* __restrict__ pre,
                     float* __restrict__ pim) {
  __shared__ __align__(16) float a_s[2][kBK][kPitchA];
  __shared__ __align__(16) float b_s[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBM / kTM);  // frames f0 + 4*tx + {0..3}, +32
  const int ty = tid / (kBM / kTM);  // columns c0 + 4*ty + {0..3}, +64
  const int f0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * kBN;

  // one stage: kBK taps x kBM frames of signal, kBK x kBN of basis
  auto load_stage = [&](int buf, int k0) {
#pragma unroll
    for (int r = 0; r < (kBK * kBM) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int k = e % kBK;  // neighbouring threads: neighbouring samples
      const int m = e / kBK;
      const long long src = (long long)(f0 + m) * hop + (k0 + k) - pad;
      const bool ok = f0 + m < n_frames && src >= 0 && src < n_samples;
      cp_async4(&a_s[buf][k][m], ok ? y + src : y, ok ? 4 : 0);
    }
#pragma unroll
    for (int r = 0; r < (kBK * kBN / 4) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int k = e / (kBN / 4);
      const int c = (e % (kBN / 4)) * 4;
      cp_async16(&b_s[buf][k][c], basis + (long long)(k0 + k) * n_cols + c0 + c);
    }
    cp_async_commit();
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int n_stages = n_taps / kBK;
  load_stage(0, 0);
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_stages) {
      load_stage(buf ^ 1, (s + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][4 * tx]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][k][32 + 4 * tx]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][k][4 * ty]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[buf][k][64 + 4 * ty]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the next iteration's copy overwrites this buffer
    __syncthreads();
  }

  // epilogue: columns (2q, 2q+1) of the thread are bin c0/2 + local bin
  const int nyquist = n_bins - 1;
#pragma unroll
  for (int q = 0; q < kTN / 2; ++q) {
    const int b = c0 / 2 + (q < 2 ? 2 * ty + q : 32 + 2 * ty + (q - 2));
    if (b >= nyquist) continue;  // columns past n_fft: padding
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int f = f0 + (i < 4 ? 4 * tx + i : 32 + 4 * tx + (i - 4));
      if (f >= n_frames) continue;
      const float r = acc[i][2 * q];
      const float im = acc[i][2 * q + 1];
      if (b == 0) {  // the shared pair: bin 0 and the Nyquist bin, both real
        store_bin(mag, pre, pim, f, r, 0.f);
        store_bin(mag, pre, pim, (long long)nyquist * n_frames + f, im, 0.f);
      } else {
        store_bin(mag, pre, pim, (long long)b * n_frames + f, r, im);
      }
    }
  }
}

}  // namespace

// C entry point for ctypes.  All pointers are device pointers; ``phase`` is
// the (2, n_bins, n_frames) output (real plane, then imaginary plane);
// ``basis`` is (n_taps, n_cols) in the paired layout above, with n_taps a
// multiple of 16, n_cols a multiple of 128 and at least 2 * (n_bins - 1).
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int svs_stft_magphase(const float* y, long long n_samples,
                                 const float* basis, int n_taps, int n_cols,
                                 int hop, int pad, int n_bins, int n_frames,
                                 float* mag, float* phase, void* stream) {
  if (n_taps % kBK != 0 || n_cols % kBN != 0 || n_frames <= 0 ||
      n_bins < 2 || 2 * (n_bins - 1) > n_cols)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_frames + kBM - 1) / kBM, n_cols / kBN);
  const long long plane = (long long)n_bins * n_frames;
  stft_magphase_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      y, n_samples, basis, n_taps, n_cols, hop, pad, n_bins, n_frames, mag,
      phase, phase + plane);
  return (int)cudaGetLastError();
}

// Fused STFT front end for Hopper (sm_90a), true float32, as a real FFT in
// shared memory: magnitude and phase, or magnitude alone.  The fft route,
// for a power-of-two n_fft in [64, 4096] (every geometry the presets use);
// stft_mixed.cu takes every other n_fft up to 16384 and stft_magphase.cu's
// GEMM an even one above (the wrapper, svs_torch/ops/cuda/dsp.py, picks
// the route by n_fft).
//
// Replaces two TPU kernels of svs_tpu/ops/pallas/dsp.py:
// - stft_magphase (_stft_magphase_kernel): centre constant pad,
//   periodic-hann windowed real DFT, magnitude, and the unit-phase real/imag
//   planes with 1+0j where mag <= 1e-30 (librosa.magphase contract);
// - stft_magnitude (_stft_mag_kernel): the same front end, magnitude only.
// One template serves both: kPhase says whether the epilogue (store_bin,
// shared with the gemm route) also writes the two phase planes.
//
// Bound: bytes.  At the 4-minute decode shape (2,097,152 samples, 2,731
// frames, n_fft 1024) the function reads 8.4 MB of signal and writes 5.6 MB
// a plane (one plane, or three with the phase): 4-7.5 us at 3.35 TB/s on an
// H100 SXM, against ~82 MFLOP of FFT work, ~1.2 us at 67 TFLOP/s of f32.
// The DFT as a GEMM (the gemm route) does 5.7 GFLOP there, ~86 us at that
// peak.
//
// Design, per block of kF frames (N = n_fft, M = N/2):
// 1. Stage: the block's frames overlap (hop < N), so the contiguous span of
//    signal they cover, [f0*hop - N/2, (f0+kF-1)*hop + N/2), is read from
//    device memory once, neighbouring threads on neighbouring samples,
//    zeros outside [0, n_samples): the centre pad and the frames past the
//    end.  For hop > N the frames are staged side by side instead.
// 2. Pack: frame f's windowed samples as M complex values
//    z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1]; each thread holds 8 of them
//    in registers (M/64 above M = 512: 64 threads a frame).
// 3. FFT: radix-8 Stockham passes (then one radix-2 or radix-4 pass where
//    log2 M is no multiple of 3; 3 radix-8 passes at N = 1024), exchanging
//    through shared memory between passes.  Stockham keeps the natural
//    order, so there is no bit reversal.  Twiddles come from a table of
//    exp(-2 pi i k / N), built in float64 on the host and rounded to f32
//    (no __sinf / __cosf).
// 4. Split and store: bin k = E[k] + W^k O[k] with E and O the DFTs of the
//    even and odd samples, from Z[k] and conj Z[M-k]; bins 0 and M are
//    Re Z[0] + Im Z[0] and Re Z[0] - Im Z[0].  Each thread keeps one frame
//    and walks the bins, so a warp writes runs of kF consecutive frames
//    (32 bytes at N = 1024) of each row of the (n_bins, n_frames) output.
//    The wrapper pads the rows to a multiple of 8 frames (pitch ld), so a
//    run fills whole 32-byte sectors: rows of odd length split every run
//    over two sectors, and the phase planes' stores then held the kernel
//    back (the planes outgrow L2 at hop 256).
// The span and the FFT's planes share one dynamic shared-memory buffer: the
// span is dead once every thread has packed its values.

#include <cuda_runtime.h>

#include "fft_radix.cuh"
#include "stft_epilogue.cuh"

namespace {

// The block's tile for an M-point complex FFT (n_fft = 2M).
template <int M>
struct Tile {
  // points a thread holds: 8 up to M = 512, then 64 threads a frame
  static constexpr int kP = M <= 512 ? 8 : M / 64;
  static constexpr int kT = M / kP;  // threads a frame
  // frames a block: 8 from M = 512 (512 threads; 342 blocks at the decode
  // shape, at most 3 an SM), 16 below; more frames a block left SMs idle
  // at the decode shape, fewer shortened the output rows' runs
  static constexpr int kF = M <= 256 ? 16 : 8;
  static constexpr int kThreads = kF * kT;
  // a frame's plane: index i lives at pad(i) = i + i/8, so the first
  // passes' stores (strides of 8 and 64 points) spread over the banks; the
  // pitch is 4 mod 32, so the epilogue's 8 frames x 4 bins of a warp do too
  static constexpr int kPitch = ((M + M / 8 + 31) / 32) * 32 + 4;
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

// The Stockham pass of radix R after passes whose radices multiply to Ns,
// then the passes after it.  Thread t of a frame holds butterflies
// j = t + q*T (q < P/R), point r of butterfly j being z[j + r*M/R]; the
// pass turns point r by exp(-2 pi i r (j % Ns) / (Ns R)), takes the R-point
// DFT and writes output r to (j / Ns) * Ns * R + r * Ns + j % Ns.  On entry
// vr/vi hold the pass's points; on return the FFT is in re/im (natural
// order, padded) and every thread of the block has passed a barrier.
// Offsets are pad(base) + a constant: pad(i + 8c) = pad(i) + 9c.
template <int M, int Ns>
__device__ __forceinline__ void fft_passes(float* vr, float* vi, int t,
                                           float* re, float* im,
                                           const float2* __restrict__ tw) {
  constexpr int P = Tile<M>::kP;
  constexpr int T = Tile<M>::kT;
  constexpr int R = M / Ns >= 8 ? 8 : M / Ns;
  constexpr int N = 2 * M;
  if constexpr (Ns > 1) {
#pragma unroll
    for (int q = 0; q < P / R; ++q) {
      const int b = (t + q * T) & (Ns - 1);
#pragma unroll
      for (int r = 1; r < R; ++r)
        cmul(vr[q * R + r], vi[q * R + r],
             __ldg(tw + r * b * (N / (Ns * R))));
    }
  }
#pragma unroll
  for (int q = 0; q < P / R; ++q) {
    if constexpr (R == 8) {
      fft8(vr + 8 * q, vi + 8 * q);
    } else if constexpr (R == 4) {
      fft4(vr + 4 * q, vi + 4 * q);
    } else {
      fft2(vr[2 * q], vi[2 * q], vr[2 * q + 1], vi[2 * q + 1]);
    }
  }
  // Ns is 1 (then d = 8j) or a multiple of 8
  constexpr int kOut = Ns == 1 ? 1 : Ns / 8 * 9;
#pragma unroll
  for (int q = 0; q < P / R; ++q) {
    const int j = t + q * T;
    const int b = j & (Ns - 1);
    const int o = pad((j - b) * R + b);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      re[o + r * kOut] = vr[q * R + r];
      im[o + r * kOut] = vi[q * R + r];
    }
  }
  __syncthreads();
  if constexpr (Ns * R < M) {
    constexpr int R2 = M / (Ns * R) >= 8 ? 8 : M / (Ns * R);
    constexpr int kIn = M / R2 / 8 * 9;  // M / R2 is a multiple of 8
#pragma unroll
    for (int q = 0; q < P / R2; ++q) {
      const int o = pad(t + q * T);
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        vr[q * R2 + r] = re[o + r * kIn];
        vi[q * R2 + r] = im[o + r * kIn];
      }
    }
    __syncthreads();  // the next pass overwrites what was just read
    fft_passes<M, Ns * R>(vr, vi, t, re, im, tw);
  }
}

// One block: kF frames from f0 = blockIdx.x * kF.  window is (M,) pairs
// (w[2n], w[2n+1]), tw the (N,) table exp(-2 pi i k / N).  Without kPhase,
// pre and pim are not touched (null).
template <int kLogM, bool kPhase>
__global__ void __launch_bounds__(Tile<(1 << kLogM)>::kThreads)
stft_fft_kernel(const float* __restrict__ y, long long n_samples,
                const float2* __restrict__ window,
                const float2* __restrict__ tw, int hop, int n_frames,
                int ld, float* __restrict__ mag, float* __restrict__ pre,
                float* __restrict__ pim) {
  constexpr int M = 1 << kLogM;
  constexpr int N = 2 * M;
  using G = Tile<M>;
  constexpr int P = G::kP;
  extern __shared__ float smem[];

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * G::kF;

  // 1. stage the span; frame f starts at smem[f * stride], and element e
  // of the span is y[base + e] for e in [lo, hi), zero elsewhere
  const int stride = hop < N ? hop : N;
  const int span = (G::kF - 1) * stride + N;
  const long long base = (long long)f0 * hop - M;
  if (hop <= N) {
    const int lo = (int)min(max(-base, 0LL), (long long)span);
    const int hi = (int)min(max(n_samples - base, 0LL), (long long)span);
    for (int e = tid; e < span; e += G::kThreads)
      smem[e] = e >= lo && e < hi ? __ldg(y + (base + e)) : 0.f;
  } else {
    for (int e = tid; e < span; e += G::kThreads) {
      const long long src = base + (long long)(e / N) * hop + e % N;
      smem[e] = src >= 0 && src < n_samples ? __ldg(y + src) : 0.f;
    }
  }
  __syncthreads();

  // 2. window and pack: point 8q + r of thread t is z[t + q*T + r*M/8]
  const int f = tid / G::kT;
  const int t = tid % G::kT;
  const float* x = smem + f * stride;
  float vr[P], vi[P];
#pragma unroll
  for (int q = 0; q < P / 8; ++q)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = t + q * G::kT + r * (M / 8);
      const float2 w = __ldg(window + n);
      const float2 v = stride % 2 == 0
                           ? reinterpret_cast<const float2*>(x)[n]
                           : make_float2(x[2 * n], x[2 * n + 1]);
      vr[8 * q + r] = v.x * w.x;
      vi[8 * q + r] = v.y * w.y;
    }
  __syncthreads();  // the planes overwrite the span

  // 3. the M-point FFT of every frame, into the planes
  float* re = smem;
  float* im = smem + G::kF * G::kPitch;
  fft_passes<M, 1>(vr, vi, t, re + f * G::kPitch, im + f * G::kPitch, tw);

  // 4. split into bins and store: the thread keeps one frame and walks
  // bins k0 + i*kT, so a warp writes runs of kF consecutive frames of each
  // bin row; the kF threads with k0 = 0 also take bin M
  const int ff = tid % G::kF;
  const int k0 = tid / G::kF;
  const int frame = f0 + ff;
  if (frame >= n_frames) return;
  const float* zr = re + ff * G::kPitch;
  const float* zi = im + ff * G::kPitch;
  const long long out = (long long)k0 * ld + frame;
  const long long step = (long long)G::kT * ld;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int k = k0 + i * G::kT;
    float xr, xi;
    if (k == 0) {  // bins 0 and M are real
      xr = zr[0] + zi[0];
      xi = 0.f;
      store_bin<kPhase>(mag, pre, pim, (long long)M * ld + frame,
                        zr[0] - zi[0], 0.f);
    } else {
      const int a = pad(k), b = pad(M - k);
      const float ar = zr[a], ai = zi[a], br = zr[b], bi = zi[b];
      const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
      const float orr = 0.5f * (ai + bi), oi = 0.5f * (br - ar);
      const float2 w = __ldg(tw + k);
      xr = er + (w.x * orr - w.y * oi);
      xi = ei + (w.x * oi + w.y * orr);
    }
    store_bin<kPhase>(mag, pre, pim, out + i * step, xr, xi);
  }
}

template <int kLogM, bool kPhase>
int launch(const float* y, long long n_samples, const float* window,
           const float* tw, int hop, int n_frames, int ld, float* mag,
           float* pre, float* pim, cudaStream_t stream) {
  using G = Tile<(1 << kLogM)>;
  constexpr int N = 2 << kLogM;
  const int stride = hop < N ? hop : N;
  const int span = (G::kF - 1) * stride + N;
  const int planes = 2 * G::kF * G::kPitch;
  const int bytes = (int)sizeof(float) * (span > planes ? span : planes);
  const auto kernel = stft_fft_kernel<kLogM, kPhase>;
  // the opt-in above 48 KB has to precede the launch (n_fft 4096 takes
  // 148 KB); an error is returned, not launched past
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + G::kF - 1) / G::kF);
  kernel<<<grid, G::kThreads, bytes, stream>>>(
      y, n_samples, reinterpret_cast<const float2*>(window),
      reinterpret_cast<const float2*>(tw), hop, n_frames, ld, mag, pre, pim);
  return (int)cudaGetLastError();
}

template <bool kPhase>
int dispatch(const float* y, long long n_samples, const float* window,
             const float* tw, int n_fft, int hop, int n_frames, int ld,
             float* mag, float* pre, float* pim, void* stream) {
  if (hop < 1 || n_frames < 1 || ld < n_frames)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (n_fft) {
    case 64:
      return launch<5, kPhase>(y, n_samples, window, tw, hop, n_frames,
                               ld, mag, pre, pim, s);
    case 128:
      return launch<6, kPhase>(y, n_samples, window, tw, hop, n_frames,
                               ld, mag, pre, pim, s);
    case 256:
      return launch<7, kPhase>(y, n_samples, window, tw, hop, n_frames,
                               ld, mag, pre, pim, s);
    case 512:
      return launch<8, kPhase>(y, n_samples, window, tw, hop, n_frames,
                               ld, mag, pre, pim, s);
    case 1024:
      return launch<9, kPhase>(y, n_samples, window, tw, hop, n_frames,
                               ld, mag, pre, pim, s);
    case 2048:
      return launch<10, kPhase>(y, n_samples, window, tw, hop, n_frames,
                                ld, mag, pre, pim, s);
    case 4096:
      return launch<11, kPhase>(y, n_samples, window, tw, hop, n_frames,
                                ld, mag, pre, pim, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry points for ctypes.  All pointers are device pointers: ``window``
// is the (n_fft,) periodic hann window, ``tw`` the (n_fft, 2) table
// (cos, -sin) of 2 pi k / n_fft, both f32; ``mag`` is the (n_bins, ld)
// output and ``phase`` the (2, n_bins, ld) one (real plane, then imaginary
// plane), of which the first n_frames columns are written.  n_fft is a power
// of two in [64, 4096]; ld >= n_frames is the rows' pitch in floats.  Each
// launches on ``stream`` and returns the CUDA error (0 on success).

extern "C" int svs_stft_fft_magphase(const float* y, long long n_samples,
                                     const float* window, const float* tw,
                                     int n_fft, int hop, int n_frames, int ld,
                                     float* mag, float* phase, void* stream) {
  const long long plane = (long long)(n_fft / 2 + 1) * ld;
  return dispatch<true>(y, n_samples, window, tw, n_fft, hop, n_frames, ld,
                        mag, phase, phase + plane, stream);
}

// The magnitude alone (TPU kernel stft_magnitude).
extern "C" int svs_stft_fft_magnitude(const float* y, long long n_samples,
                                      const float* window, const float* tw,
                                      int n_fft, int hop, int n_frames,
                                      int ld, float* mag, void* stream) {
  return dispatch<false>(y, n_samples, window, tw, n_fft, hop, n_frames, ld,
                         mag, nullptr, nullptr, stream);
}

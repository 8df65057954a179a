// Fused STFT front end for Hopper (sm_90a), true float32, as a mixed-radix
// or Bluestein FFT in shared memory: magnitude and phase, or magnitude
// alone.  The mixed route, for every n_fft in [2, 16384] that the fft route
// (stft_fft.cu, a power of two in [64, 4096]) does not take, odd ones
// included; the wrapper, svs_torch/ops/cuda/dsp.py, picks the route by
// n_fft and chooses the pass plan on the host (dsp.mixed_plan).
//
// Replaces two TPU kernels of svs_tpu/ops/pallas/dsp.py:
// - stft_magphase (_stft_magphase_kernel): centre constant pad,
//   periodic-hann windowed real DFT, magnitude, and the unit-phase real/imag
//   planes with 1+0j where mag <= 1e-30 (librosa.magphase contract);
// - stft_magnitude (_stft_mag_kernel): the same front end, magnitude only.
// One template serves both: kPhase says whether the epilogue (store_bin,
// shared with the other routes) also writes the two phase planes.
//
// Bound: bytes.  At n_fft 1000 / hop 250 on a 4-minute song (2,097,152
// samples, 8,389 frames, 501 bins) the function reads 8.4 MB of signal and
// writes 16.8 MB a plane (one plane, or three with the phase): 7.5-17.6 us
// at 3.35 TB/s on an H100 SXM, against ~0.2 GFLOP of FFT work.  The DFT as
// a GEMM (the gemm route, stft_magphase.cu, which this route replaces for
// these n_fft) does 16.8 GFLOP there.
//
// Design, stft_fft.cu's generalised; per block of `seqs` packed sequences:
// 1. Stage: the block's frames' signal span is read from device memory
//    once (side by side where hop > n_fft), zeros outside the signal.
// 2. Pack: an even n_fft packs a frame as P = n_fft/2 complex values
//    z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1]; an odd n_fft packs two frames
//    a and b as the P = n_fft values z[n] = (x_a[n] + i x_b[n]) w[n] (an
//    odd frame count pairs the last frame with zeros).  The threads write
//    them from the span straight into the planes, which sit beside it in
//    shared memory (where the span does not fit there too, an odd n_fft
//    above ~12,000 at a long hop, the pack reads the signal itself).
// 3. FFT of length q over the host's plan of radix-8, 4, 2, 3, 5 and 7
//    passes (one kernel for every plan, no template a size), in place in
//    shared memory, one barrier a pass:
//    - P with no prime factor above 7: q = P; the pack writes z[n] at its
//      digit-reversed place (the `perm` table) and decimation-in-time
//      passes leave the transform in natural order.
//    - Otherwise Bluestein: z[n] c[n] with the chirp c[n] = exp(-i pi n^2
//      / P) (n^2 taken mod 2P in integers on the host) zero-padded to the
//      power of two q = L >= 2P - 1, decimation-in-frequency passes of the
//      mirrored plan (natural order in, perm order out), times the chirp
//      filter's FFT (float64 on the host, over L, stored in perm order),
//      conjugated, the decimation-in-time passes, so Z[k] = c[k] conj(w[k]).
//    Twiddles come from a table of exp(-2 pi i k / q), float64 rounded to
//    f32 (no __sinf / __cosf).  A plane holds (re, im) pairs, one 64-bit
//    access a point; point i lives at i + i/16, and sequences are an odd
//    number of pairs apart, so strided passes and the epilogue's reads
//    across sequences spread over the banks.
// 4. Split and store: an even n_fft splits bin k = E[k] + W^k O[k] from
//    Z[k] and conj Z[P-k] (stft_fft.cu's step 4); an odd one separates
//    X_a[k] = (Z[k] + conj Z[P-k]) / 2 and X_b[k] = (Z[k] - conj Z[P-k]) / 2i.
//    Each thread keeps one frame and walks the bins, so a warp writes runs
//    of the block's consecutive frames of each row; the wrapper pads the
//    rows to a multiple of 8 frames (pitch ld), as for the fft route.
// Only the planes of Bluestein's L = 32768 (an odd n_fft above 8192 with a
// prime factor above 7) outgrow a block's 227 KB: that instance
// (kScratch) keeps them in a device-memory scratch of one plane pair a
// block and walks the frames with a grid-sized stride.

#include <cuda_runtime.h>

#include "fft_radix.cuh"
#include "stft_epilogue.cuh"

namespace {

constexpr int kMaxPasses = 16;    // 4 bits a radix in a 64-bit plan code
constexpr int kMaxThreads = 1024;
constexpr int kSmemMax = 232448;  // a block's opt-in shared memory

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// (re, im) pairs from one sequence's plane to the next (dsp.seq_pairs):
// point i lives at i + i/16, and the count is odd, so the epilogue's reads
// of one bin across sequences fall in different banks
__host__ __device__ __forceinline__ int seq_pairs(int q) {
  return (q + q / 16) | 1;
}

// The radix-R pass after passes whose radices multiply to ns, in place:
// butterfly j = g ns + b takes points (g R + r) ns + b.  Decimation in time
// turns point r by exp(-2 pi i r b / (ns R)) before the R-point DFT,
// decimation in frequency turns output r after it (dsp._run_passes).
template <int R, bool kDit>
__device__ __forceinline__ void radix_pass(float2* z, int q, int ns, int t,
                                           int nt,
                                           const float2* __restrict__ tw) {
  const int step = q / (ns * R);
  // j walks t, t + nt, ...: (g, b) advance by (nt / ns, nt % ns)
  const int dg = nt / ns, db = nt - dg * ns;
  int g = t / ns, b = t - g * ns;
  for (int j = t; j < q / R; j += nt) {
    const int base = g * ns * R + b;
    int o[R];
    float vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      o[r] = pad(base + r * ns);
      const float2 v = z[o[r]];
      vr[r] = v.x;
      vi[r] = v.y;
    }
    if (kDit && b > 0) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        cmul(vr[r], vi[r], __ldg(tw + r * b * step));
    }
    butterfly<R>(vr, vi);
    if (!kDit && b > 0) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        cmul(vr[r], vi[r], __ldg(tw + r * b * step));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) z[o[r]] = make_float2(vr[r], vi[r]);
    b += db;
    g += dg;
    if (b >= ns) {
      b -= ns;
      ++g;
    }
  }
}

// The plan's passes (4 bits a radix in `code`, the first pass lowest) in
// order (decimation in time) or last to first (decimation in frequency);
// every thread of the block passes a barrier after each.
template <bool kDit>
__device__ __forceinline__ void run_passes(unsigned long long code,
                                           int n_passes, float2* z, int q,
                                           int t, int nt,
                                           const float2* __restrict__ tw) {
  int ns = kDit ? 1 : q;
  for (int i = 0; i < n_passes; ++i) {
    const int p = kDit ? i : n_passes - 1 - i;
    const int radix = (int)(code >> (4 * p)) & 15;
    if (!kDit) ns /= radix;
    switch (radix) {
      case 8: radix_pass<8, kDit>(z, q, ns, t, nt, tw); break;
      case 4: radix_pass<4, kDit>(z, q, ns, t, nt, tw); break;
      case 2: radix_pass<2, kDit>(z, q, ns, t, nt, tw); break;
      case 3: radix_pass<3, kDit>(z, q, ns, t, nt, tw); break;
      case 5: radix_pass<5, kDit>(z, q, ns, t, nt, tw); break;
      case 7: radix_pass<7, kDit>(z, q, ns, t, nt, tw); break;
    }
    if (kDit) ns *= radix;
    __syncthreads();
  }
}

// Z[k] of a sequence's planes: the DIT output, or for Bluestein
// c[k] conj(w[k])
__device__ __forceinline__ void load_z(const float2* z, int k, bool blue,
                                       const float2* __restrict__ chirp,
                                       float& r, float& i) {
  const float2 v = z[pad(k)];
  r = v.x;
  i = v.y;
  if (blue) {
    i = -i;
    cmul(r, i, __ldg(chirp + k));
  }
}

// Blocks of `seqs` sequences of `threads` threads each; block blk takes
// frames [blk * fb, blk * fb + fb), fb = seqs (even n_fft) or 2 seqs (odd).
// window is (n_fft,), tw (q,) exp(-2 pi i k / q), split (P,)
// exp(-2 pi i k / n_fft) (even n_fft), chirp (P,) and filt (q,) (Bluestein),
// perm (q,) the digit reversal.  The planes take the front of the shared
// memory (unless kScratch puts them in device memory) and the staged span
// the rest; without `staged` (the span does not fit beside the planes) the
// pack reads the signal itself.  Without kPhase, pre and pim are not
// touched (null).
template <bool kPhase, bool kScratch>
__global__ void __launch_bounds__(kMaxThreads)
stft_mixed_kernel(const float* __restrict__ y, long long n_samples,
                  const float* __restrict__ window,
                  const float2* __restrict__ tw,
                  const float2* __restrict__ split,
                  const float2* __restrict__ chirp,
                  const float2* __restrict__ filt,
                  const int* __restrict__ perm, float* __restrict__ scratch,
                  unsigned long long code, int n_passes, int n_fft, int q,
                  int seqs, int threads, bool staged, int hop, int n_frames,
                  int ld, float* __restrict__ mag, float* __restrict__ pre,
                  float* __restrict__ pim) {
  extern __shared__ float smem[];
  const bool odd = n_fft & 1;
  const int P = odd ? n_fft : n_fft / 2;
  const bool blue = q != P;
  const int fb = odd ? 2 * seqs : seqs;
  const int nt = seqs * threads;
  const int stride = hop < n_fft ? hop : n_fft;
  const int span = (fb - 1) * stride + n_fft;

  const int tid = threadIdx.x;
  const int s = tid / threads;
  const int t = tid - s * threads;
  float2* planes = reinterpret_cast<float2*>(smem);
  float* x = smem + 2 * seqs * seq_pairs(q);
  if constexpr (kScratch) {
    planes = reinterpret_cast<float2*>(scratch) +
             (long long)blockIdx.x * seq_pairs(q);
    x = smem;
  }
  float2* z = planes + s * seq_pairs(q);

  const int n_blocks = (n_frames + fb - 1) / fb;
  for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const int f0 = blk * fb;
    // 1. stage the span; frame f starts at x[f * stride], and element e of
    // the span is y[base + e] for e in [lo, hi), zero elsewhere
    const long long base = (long long)f0 * hop - n_fft / 2;
    if (staged && hop <= n_fft) {
      const int lo = (int)min(max(-base, 0LL), (long long)span);
      const int hi = (int)min(max(n_samples - base, 0LL), (long long)span);
      for (int e = tid; e < span; e += nt)
        x[e] = e >= lo && e < hi ? __ldg(y + (base + e)) : 0.f;
    } else if (staged) {
      for (int e = tid; e < span; e += nt) {
        const long long src = base + (long long)(e / n_fft) * hop + e % n_fft;
        x[e] = src >= 0 && src < n_samples ? __ldg(y + src) : 0.f;
      }
    }
    __syncthreads();

    // 2. window and pack: point n of sequence s, at its digit-reversed
    // place (or, for Bluestein, times the chirp, in natural order)
    auto sample = [&](int f, int e) {
      if (staged) return x[f * stride + e];
      const long long src = base + (long long)f * hop + e;
      return src >= 0 && src < n_samples ? __ldg(y + src) : 0.f;
    };
    for (int n = t; n < P; n += threads) {
      float a, b;
      if (odd) {
        const float w = __ldg(window + n);
        a = sample(2 * s, n) * w;
        b = f0 + 2 * s + 1 < n_frames ? sample(2 * s + 1, n) * w : 0.f;
      } else {
        const float2 w = __ldg(reinterpret_cast<const float2*>(window) + n);
        a = sample(s, 2 * n) * w.x;
        b = sample(s, 2 * n + 1) * w.y;
      }
      if (blue) cmul(a, b, __ldg(chirp + n));
      z[pad(blue ? n : __ldg(perm + n))] = make_float2(a, b);
    }
    if (blue) {
      for (int n = P + t; n < q; n += threads)
        z[pad(n)] = make_float2(0.f, 0.f);
    }
    __syncthreads();

    // 3. the q-point FFT of every sequence, in place
    if (blue) {
      run_passes<false>(code, n_passes, z, q, t, threads, tw);
      for (int i = t; i < q; i += threads) {  // the filter, conjugated
        float2 v = z[pad(i)];
        cmul(v.x, v.y, __ldg(filt + i));
        z[pad(i)] = make_float2(v.x, -v.y);
      }
      __syncthreads();
    }
    run_passes<true>(code, n_passes, z, q, t, threads, tw);

    // 4. split into bins and store: the thread keeps frame f0 + ff and
    // walks bins k0 + i * step; for an even n_fft the thread with k0 = 0
    // also takes bin P
    const int ff = tid % fb;
    const int k0 = tid / fb;
    const int step = nt / fb;
    const int frame = f0 + ff;
    if (frame < n_frames) {
      const float2* zf = planes + (odd ? ff / 2 : ff) * seq_pairs(q);
      const int n_k = odd ? (n_fft + 1) / 2 : P;
      for (int k = k0; k < n_k; k += step) {
        const long long o = (long long)k * ld + frame;
        float ar, ai, br, bi;
        load_z(zf, k, blue, chirp, ar, ai);
        if (k == 0) {
          br = ar;
          bi = ai;
        } else {
          load_z(zf, P - k, blue, chirp, br, bi);
        }
        float xr, xi;
        if (odd) {
          if (ff & 1) {  // X_b = (Z[k] - conj Z[P-k]) / 2i
            xr = 0.5f * (ai + bi);
            xi = 0.5f * (br - ar);
          } else {       // X_a = (Z[k] + conj Z[P-k]) / 2
            xr = 0.5f * (ar + br);
            xi = 0.5f * (ai - bi);
          }
        } else if (k == 0) {  // bins 0 and P are real
          xr = ar + ai;
          xi = 0.f;
          store_bin<kPhase>(mag, pre, pim, (long long)P * ld + frame,
                            ar - ai, 0.f);
        } else {
          const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
          const float orr = 0.5f * (ai + bi), oi = 0.5f * (br - ar);
          const float2 w = __ldg(split + k);
          xr = er + (w.x * orr - w.y * oi);
          xi = ei + (w.x * oi + w.y * orr);
        }
        store_bin<kPhase>(mag, pre, pim, o, xr, xi);
      }
    }
    __syncthreads();  // the next frames' pack overwrites the planes
  }
}

// The planes' and the span's shared memory (bytes); dsp.mixed_geometry
// mirrors both.
long long planes_bytes(int q, int seqs, bool scratch) {
  return scratch ? 0 : 8LL * seqs * seq_pairs(q);
}

long long span_bytes(int n_fft, int seqs, int hop) {
  const int fb = n_fft % 2 ? 2 * seqs : seqs;
  const int stride = hop < n_fft ? hop : n_fft;
  return 4LL * ((long long)(fb - 1) * stride + n_fft);
}

template <bool kPhase>
int dispatch(const float* y, long long n_samples, const float* window,
             const float* tw, const float* split, const float* chirp,
             const float* filt, const int* perm, float* scratch,
             const int* radices, int n_passes, int n_fft, int q, int seqs,
             int threads, int grid, int hop, int n_frames, int ld, float* mag,
             float* pre, float* pim, void* stream) {
  const int P = n_fft % 2 ? n_fft : n_fft / 2;
  if (n_passes < 0 || n_passes > kMaxPasses) return (int)cudaErrorInvalidValue;
  unsigned long long code = 0;
  long long product = 1;
  for (int p = 0; p < n_passes; ++p) {
    const int r = radices[p];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8)
      return (int)cudaErrorInvalidValue;
    code |= (unsigned long long)r << (4 * p);
    product *= r;
  }
  const bool in_scratch = scratch != nullptr;
  const long long planes = planes_bytes(q, seqs, in_scratch);
  const long long span = span_bytes(n_fft, seqs, hop);
  const bool staged = planes + span <= kSmemMax;
  const long long bytes = staged ? planes + span : planes;
  if (n_fft < 2 || product != q || q < P || (q > P && q < 2 * P - 1) ||
      hop < 1 || n_frames < 1 || ld < n_frames || seqs < 1 ||
      threads < 1 || threads % 2 || seqs * threads > kMaxThreads ||
      grid < 1 || bytes > kSmemMax ||
      in_scratch != (8LL * seq_pairs(q) > kSmemMax) ||
      (in_scratch && seqs != 1))
    return (int)cudaErrorInvalidValue;
  const auto kernel = in_scratch ? stft_mixed_kernel<kPhase, true>
                                 : stft_mixed_kernel<kPhase, false>;
  // the opt-in above 48 KB has to precede the launch; an error is
  // returned, not launched past
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, seqs * threads, bytes, (cudaStream_t)stream>>>(
      y, n_samples, window, reinterpret_cast<const float2*>(tw),
      reinterpret_cast<const float2*>(split),
      reinterpret_cast<const float2*>(chirp),
      reinterpret_cast<const float2*>(filt), perm, scratch, code, n_passes,
      n_fft, q, seqs, threads, staged, hop, n_frames, ld, mag, pre, pim);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points for ctypes.  Device pointers: the signal, the tables of
// dsp.mixed_tables (window (n_fft,), tw (q, 2), split (n_fft/2, 2), chirp
// (P, 2), filt (q, 2), all f32, perm (q,) int32), ``scratch`` (null unless
// the planes outgrow shared memory: then grid * seq_pairs(q) float pairs) and
// the outputs, ``mag`` (n_bins, ld) and ``phase`` (2, n_bins, ld) (real
// plane, then imaginary plane), of which the first n_frames columns are
// written.  ``radices`` is a host array of the n_passes radices of the
// decimation-in-time plan, whose product is q.  seqs sequences of
// ``threads`` threads make a block; ``grid`` blocks are launched (every
// block of frames, or fewer with the scratch).  Each launches on
// ``stream`` and returns the CUDA error (0 on success).

extern "C" int svs_stft_mixed_magphase(
    const float* y, long long n_samples, const float* window, const float* tw,
    const float* split, const float* chirp, const float* filt,
    const int* perm, float* scratch, const int* radices, int n_passes,
    int n_fft, int q, int seqs, int threads, int grid, int hop, int n_frames,
    int ld, float* mag, float* phase, void* stream) {
  const long long plane = (long long)(n_fft / 2 + 1) * ld;
  return dispatch<true>(y, n_samples, window, tw, split, chirp, filt, perm,
                        scratch, radices, n_passes, n_fft, q, seqs, threads,
                        grid, hop, n_frames, ld, mag, phase, phase + plane,
                        stream);
}

// The magnitude alone (TPU kernel stft_magnitude).
extern "C" int svs_stft_mixed_magnitude(
    const float* y, long long n_samples, const float* window, const float* tw,
    const float* split, const float* chirp, const float* filt,
    const int* perm, float* scratch, const int* radices, int n_passes,
    int n_fft, int q, int seqs, int threads, int grid, int hop, int n_frames,
    int ld, float* mag, void* stream) {
  return dispatch<false>(y, n_samples, window, tw, split, chirp, filt, perm,
                         scratch, radices, n_passes, n_fft, q, seqs, threads,
                         grid, hop, n_frames, ld, mag, nullptr, nullptr,
                         stream);
}

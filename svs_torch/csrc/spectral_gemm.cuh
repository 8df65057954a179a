// The implicit-framing windowed-DFT GEMM on the bf16 tensor cores, and its
// adjoint, shared by the MR-STFT loss kernels for Hopper (sm_90a):
// diff_mag.cu (spectral_mag) and fused_loss.cu (loss_partials).
//
// Replaces the GEMMs of the TPU kernels svs_tpu/ops/pallas/diff_mag.py and
// svs_tpu/ops/pallas/fused_loss.py.  Those cut the reflect-padded signal
// into K hop-shifted row views, pad the bins to 128 lanes and take K MXU
// dots of depth hop per 256-frame block, then fold K per-shift gradient
// planes in XLA.  None of that layout is carried over:
//
// Forward (fwd_kernel).  With xp the reflect-padded bf16 signal of one
// example, the frames are an implicit operand,
//     A[f, i] = xp[f*hop + tap_lo + i],        i < n_taps,
// staged straight from xp into shared memory (no frame matrix in memory).
// i runs only over the taps where the centred window is non-zero, rounded
// up to whole 32-tap stages (the basis is zero on the rest), so the
// contraction is win deep, not n_fft.  The basis carries the window; its
// columns hold one bin per pair: 2q is the cosine of bin q and 2q+1 its
// sine for 1 <= q < n_fft/2, and bin 0 and the Nyquist bin, whose sines are
// zero, share pair 0.  So n_fft columns hold the n_fft/2 + 1 bins, and the
// m16n8k16 accumulator layout puts a bin's re and im in one thread's
// registers.  Each block computes 128 signal rows x 128 columns over the
// taps in 32-deep stages, double-buffered with cp.async; eight warps each
// own a 64 x 32 (one signal) or two 32 x 32 (two signals) accumulator
// tile and issue mma.sync m16n8k16 bf16 -> f32 from ldmatrix fragments.
// The epilogue is the kernel's own (template parameter EPI):
//   kMag      |X| = sqrt(max(re^2 + im^2, 1e-8)) into (B, n_bins, n_frames)
//   kGradMag  the bf16 column cotangent of spectral_mag (diff_mag.py:107-113)
//   kPartials per-block sums of (|Y|-|X|)^2, |Y|^2, |log|X| - log|Y||
//             (fused_loss.py:175-191), x and y sharing each basis tile
//   kGradLoss the bf16 column cotangent of loss_partials
//             (fused_loss.py:243-264)
//
// Adjoint (adjoint_kernel).  The column cotangent G (B, n_frames, n_fft,
// bf16) goes back to hop-wide rows r of the padded signal's cotangent:
//     out[r, c] = sum_j sum_col G[r - j, col] * basis[j*hop + c, col]
// one GEMM whose A operand is G shifted by j rows, again implicit.  That is
// the overlap-add of G @ basis^T done in the accumulators: no K planes in
// memory, no atomics, the same result on every run.  Shifts whose taps miss
// the window are skipped.
//
// Bound of this formulation at the train step's shapes (B = 32, 97,536
// samples): a forward call's GEMM does 16-65 GFLOP per signal
// (window-deep contraction), 17-66 us at the H100 SXM's 989 TFLOP/s of
// dense bf16, above the functions' own least work (diff_mag.cu,
// fused_loss.cu); this first version, on mma.sync rather than wgmma, runs
// well below that peak.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spec {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 128;     // forward: signal rows per block (all signals)
constexpr int kBN = 128;       // forward: basis columns per block (64 bins)
constexpr int kBK = 32;        // contraction per shared-memory stage
// +8 bf16 of row pitch (80 B): the 8 rows one ldmatrix phase reads land in
// 8 distinct 16-byte bank groups, and rows stay 16-byte aligned
constexpr int kPitch = kBK + 8;
constexpr int kAdjBM = 128;  // adjoint: hop rows per block
constexpr int kAdjBN = 64;   // adjoint: hop columns per block
constexpr float kEps = 1e-8f;  // power clip (auraloss)

enum Epilogue { kMag = 0, kGradMag = 1, kPartials = 2, kGradLoss = 3 };

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// async copies; a false ``ok`` writes zeros without reading ``src``
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// D += A (16x16, row) * B (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragments of four n8 tiles (a warp's 32 columns) at depth kk from a
// [column][contraction] tile
__device__ __forceinline__ void load_b_frags(unsigned (&bf)[4][2],
                                             const bf16 (*tile)[kPitch],
                                             int n0, int kk, int lane) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    unsigned r[4];
    const int n = n0 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
    ldmatrix_x4(r, &tile[n][kk + (((lane >> 3) & 1) << 3)]);
    bf[2 * np][0] = r[0];
    bf[2 * np][1] = r[1];
    bf[2 * np + 1][0] = r[2];
    bf[2 * np + 1][1] = r[3];
  }
}

// the A fragment of one m16 tile at depth kk from a [row][contraction] tile
__device__ __forceinline__ void load_a_frag(unsigned (&af)[4],
                                            const bf16 (*tile)[kPitch],
                                            int m0, int kk, int lane) {
  ldmatrix_x4(af, &tile[m0 + (lane & 15)][kk + ((lane >> 4) << 3)]);
}

// re^2 + im^2 rounded as two products and a sum (no fused multiply-add),
// as the plain version and the TPU kernel compute it
__device__ __forceinline__ float power(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

__device__ __forceinline__ float clipped_mag(float p) {
  return sqrtf(fmaxf(p, kEps));
}

struct FwdArgs {
  // signal at its first kernel tap: (b, f, i) at x[b*stride + f*hop + i]
  const bf16* x;
  const bf16* y;  // second signal, same layout (kPartials, kGradLoss)
  long long stride;
  const bf16* taps;  // (n_cols, n_taps) basis, taps contiguous
  int n_taps, n_cols, hop, n_frames, n_bins;
  float* mag;        // kMag: (B, n_bins, n_frames)
  const float* g;    // kGradMag: (B, n_bins, n_frames); kGradLoss: (B, 3)
  bf16* g_cols;      // kGrad*: (B, n_frames, n_cols)
  float* partials;   // kPartials: (B, gridDim.x, gridDim.y, 3)
};

template <int NSIG, int EPI>
__global__ void __launch_bounds__(kThreads, 2) fwd_kernel(FwdArgs a) {
  constexpr int BM = kRows / NSIG;  // frames per block
  constexpr int MT = BM / 32;       // m16 tiles per warp (2 x 4 warp grid)
  __shared__ __align__(16) bf16 a_s[2][kRows][kPitch];
  __shared__ __align__(16) bf16 b_s[2][kBN][kPitch];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // rows wm*BM/2 .. of each signal
  const int wn = warp & 3;   // columns wn*32 ..
  const int f0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const bf16* sig0 = a.x + b * a.stride;
  const bf16* sig1 = NSIG == 2 ? a.y + b * a.stride : sig0;

  auto load_stage = [&](int buf, int k0) {
    // NSIG*BM signal rows of kBK taps as 4-byte pairs (a frame starts at
    // f*hop, so rows are only 4-byte aligned); frames past the end are zero
#pragma unroll
    for (int r = 0; r < kRows * (kBK / 2) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int row = e / (kBK / 2);
      const int pr = e % (kBK / 2);
      const int m = row % BM;
      const bool ok = f0 + m < a.n_frames;
      const bf16* base = (NSIG == 2 && row >= BM) ? sig1 : sig0;
      const bf16* src =
          base + (long long)(ok ? f0 + m : 0) * a.hop + k0 + 2 * pr;
      cp_async4(&a_s[buf][row][2 * pr], src, ok);
    }
    // kBN basis columns of kBK taps, 16-byte chunks
#pragma unroll
    for (int r = 0; r < kBN * (kBK / 8) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int n = e / (kBK / 8);
      const int ch = e % (kBK / 8);
      cp_async16(&b_s[buf][n][ch * 8],
                 a.taps + (long long)(c0 + n) * a.n_taps + k0 + ch * 8, true);
    }
    cp_async_commit();
  };

  float acc[NSIG][MT][4][4];
#pragma unroll
  for (int s = 0; s < NSIG; ++s)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[s][i][j][v] = 0.f;

  const int n_stages = a.n_taps / kBK;
  load_stage(0, 0);
  for (int st = 0; st < n_stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_stages) {
      load_stage(buf ^ 1, (st + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned bf[4][2];
      load_b_frags(bf, b_s[buf], wn * 32, kk, lane);
#pragma unroll
      for (int s = 0; s < NSIG; ++s)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned af[4];
          load_a_frag(af, a_s[buf], s * BM + wm * (BM / 2) + mt * 16, kk,
                      lane);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[s][mt][nt], af, bf[nt][0], bf[nt][1]);
        }
    }
    // the next iteration's copy overwrites this buffer
    __syncthreads();
  }

  // epilogue: accumulator (mt, nt, 2h + {0,1}) is frame row g + 8h of tile
  // mt and the column pair 2t, 2t+1 of tile nt, i.e. one bin's re and im
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nyquist = a.n_bins - 1;
  float s_diff = 0.f, s_ref = 0.f, s_log = 0.f;
  float c_diff = 0.f, c_log = 0.f;
  if (EPI == kGradLoss) {
    c_diff = a.g[b * 3 + 0];
    c_log = a.g[b * 3 + 2];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + wm * (BM / 2) + mt * 16 + g + 8 * h;
      if (f >= a.n_frames) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int q = (c0 + wn * 32 + nt * 8) / 2 + t;  // bin pair
        const float xr = acc[0][mt][nt][2 * h];
        const float xi = acc[0][mt][nt][2 * h + 1];
        const float yr = acc[NSIG - 1][mt][nt][2 * h];
        const float yi = acc[NSIG - 1][mt][nt][2 * h + 1];
        if constexpr (EPI == kMag) {
          float* out = a.mag + (long long)b * a.n_bins * a.n_frames + f;
          if (q == 0) {  // bin 0 and Nyquist, both real
            out[0] = clipped_mag(power(xr, 0.f));
            out[(long long)nyquist * a.n_frames] = clipped_mag(power(xi, 0.f));
          } else {
            out[(long long)q * a.n_frames] = clipped_mag(power(xr, xi));
          }
        } else if constexpr (EPI == kPartials) {
          auto cell = [&](float rx, float ix, float ry, float iy) {
            const float mx = clipped_mag(power(rx, ix));
            const float my = clipped_mag(power(ry, iy));
            const float d = my - mx;
            s_diff += d * d;
            s_ref += my * my;
            s_log += fabsf(logf(mx) - logf(my));
          };
          if (q == 0) {
            cell(xr, 0.f, yr, 0.f);
            cell(xi, 0.f, yi, 0.f);
          } else {
            cell(xr, xi, yr, yi);
          }
        } else {
          // d|X|/dre = re/|X| where the clip is inactive; the scaled re/im
          // cotangents are rounded to bf16 (diff_mag.py:109-113)
          auto scale_of = [&](float rx, float ix, float ry, float iy,
                              int bin) {
            const float p = power(rx, ix);
            const float mx = clipped_mag(p);
            float gm;
            if constexpr (EPI == kGradMag) {
              gm = a.g[((long long)b * a.n_bins + bin) * a.n_frames + f];
            } else {
              // d s_diff/d mx = -2 (my - mx); d s_log/d mx = sign(mx-my)/mx
              const float my = clipped_mag(power(ry, iy));
              const float sg = (float)((mx > my) - (mx < my));
              gm = __fadd_rn(__fmul_rn(c_diff * -2.0f, my - mx),
                             __fdiv_rn(__fmul_rn(c_log, sg), mx));
            }
            const float live = p >= kEps ? 1.f : 0.f;
            return __fdiv_rn(__fmul_rn(gm, live), mx);
          };
          float2 v;
          if (q == 0) {
            v.x = __fmul_rn(scale_of(xr, 0.f, yr, 0.f, 0), xr);
            v.y = __fmul_rn(scale_of(xi, 0.f, yi, 0.f, nyquist), xi);
          } else {
            const float s = scale_of(xr, xi, yr, yi, q);
            v.x = __fmul_rn(s, xr);
            v.y = __fmul_rn(s, xi);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              a.g_cols + ((long long)b * a.n_frames + f) * a.n_cols + 2 * q) =
              __floats2bfloat162_rn(v.x, v.y);
        }
      }
    }

  if constexpr (EPI == kPartials) {
    // block sums in a fixed order: warp shuffles, then warp 0's lane 0 adds
    // the eight warps; one (example, frame tile, column tile) row each
    __shared__ float red[kThreads / 32][3];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s_diff += __shfl_xor_sync(0xffffffffu, s_diff, o);
      s_ref += __shfl_xor_sync(0xffffffffu, s_ref, o);
      s_log += __shfl_xor_sync(0xffffffffu, s_log, o);
    }
    if (lane == 0) {
      red[warp][0] = s_diff;
      red[warp][1] = s_ref;
      red[warp][2] = s_log;
    }
    __syncthreads();
    if (tid < 3) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w][tid];
      a.partials[(((long long)b * gridDim.x + blockIdx.x) * gridDim.y +
                  blockIdx.y) * 3 + tid] = s;
    }
  }
}

struct AdjArgs {
  const bf16* g_cols;  // (B, n_frames, n_cols) column cotangent
  const bf16* shifts;  // (k, hop_pad, n_cols): row c of shift j = tap j*hop+c
  float* out;          // (B, rows, hop) cotangent of the padded signal
  int n_frames, n_cols, hop, hop_pad, k, rows, left, win;
};

__global__ void __launch_bounds__(kThreads, 2) adjoint_kernel(AdjArgs a) {
  __shared__ __align__(16) bf16 a_s[2][kAdjBM][kPitch];
  __shared__ __align__(16) bf16 b_s[2][kAdjBN][kPitch];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // rows wm*32 ..
  const int wn = warp & 1;   // hop columns wn*32 ..
  const int r0 = blockIdx.x * kAdjBM;
  const int c0 = blockIdx.y * kAdjBN;
  const int b = blockIdx.z;

  // the shifts j whose taps j*hop + [c0, c_hi) meet the window: a
  // contiguous run, since the window is one interval
  const int c_hi = min(c0 + kAdjBN, a.hop);
  int j_lo = a.k, j_hi = -1;
  for (int j = 0; j < a.k; ++j) {
    if (j * a.hop + c0 < a.left + a.win && j * a.hop + c_hi > a.left) {
      j_lo = min(j_lo, j);
      j_hi = j;
    }
  }
  const int n_kc = a.n_cols / kBK;
  const int n_stages = j_hi >= j_lo ? (j_hi - j_lo + 1) * n_kc : 0;
  const bf16* gb = a.g_cols + (long long)b * a.n_frames * a.n_cols;

  auto load_stage = [&](int buf, int st) {
    const int j = j_lo + st / n_kc;
    const int k0 = (st % n_kc) * kBK;
    // cotangent rows r0 + m - j (zero outside the frames), 16-byte chunks
#pragma unroll
    for (int r = 0; r < kAdjBM * (kBK / 8) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int m = e / (kBK / 8);
      const int ch = e % (kBK / 8);
      const int f = r0 + m - j;
      const bool ok = f >= 0 && f < a.n_frames;
      cp_async16(&a_s[buf][m][ch * 8],
                 gb + (long long)(ok ? f : 0) * a.n_cols + k0 + ch * 8, ok);
    }
    // kAdjBN hop columns of shift j (one 16-byte chunk per thread)
    const int n = tid / (kBK / 8);
    const int ch = tid % (kBK / 8);
    cp_async16(&b_s[buf][n][ch * 8],
               a.shifts + ((long long)j * a.hop_pad + c0 + n) * a.n_cols + k0 +
                   ch * 8,
               true);
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  if (n_stages > 0) load_stage(0, 0);
  for (int st = 0; st < n_stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_stages) {
      load_stage(buf ^ 1, st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned bf[4][2];
      load_b_frags(bf, b_s[buf], wn * 32, kk, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        unsigned af[4];
        load_a_frag(af, a_s[buf], wm * 32 + mt * 16, kk, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm * 32 + mt * 16 + g + 8 * h;
      if (r >= a.rows) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = c0 + wn * 32 + nt * 8 + 2 * t;  // even; hop is even
        if (c >= a.hop) continue;
        float* dst = a.out + ((long long)b * a.rows + r) * a.hop + c;
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// the shapes every entry point needs (see the Python wrappers)
inline bool gemm_shape_ok(long long stride, int batch, int n_taps, int n_cols,
                          int hop, int n_frames, int n_bins) {
  return batch > 0 && batch <= 65535 && n_frames > 0 && n_taps > 0 &&
         n_taps % kBK == 0 && n_cols % kBN == 0 && hop > 0 && hop % 2 == 0 &&
         stride % 2 == 0 && n_bins == n_cols / 2 + 1;
}

template <int NSIG, int EPI>
inline int launch_fwd(const FwdArgs& a, int batch, cudaStream_t stream) {
  dim3 grid(cdiv(a.n_frames, kRows / NSIG), a.n_cols / kBN, batch);
  fwd_kernel<NSIG, EPI><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

inline int launch_adjoint(const AdjArgs& a, int batch, cudaStream_t stream) {
  if (a.hop_pad % kAdjBN != 0 || a.hop > a.hop_pad || a.k < 1 ||
      a.rows != a.n_frames + a.k - 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(cdiv(a.rows, kAdjBM), a.hop_pad / kAdjBN, batch);
  adjoint_kernel<<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace spec

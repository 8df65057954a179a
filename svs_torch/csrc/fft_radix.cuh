// The complex butterflies of the STFT front ends' shared-memory FFTs
// (stft_fft.cu and stft_mixed.cu): natural order in and out, the rfft sign
// (exp(-2 pi i jk / R)), true float32.
#pragma once

namespace {

__device__ __forceinline__ void cmul(float& r, float& i, float2 w) {
  const float t = r * w.x - i * w.y;
  i = r * w.y + i * w.x;
  r = t;
}

__device__ __forceinline__ void fft2(float& ar, float& ai, float& br,
                                     float& bi) {
  const float tr = ar - br, ti = ai - bi;
  ar = ar + br;
  ai = ai + bi;
  br = tr;
  bi = ti;
}

// 4-point DFT in place of r[0..3], i[0..3], natural order in and out
__device__ __forceinline__ void fft4(float* r, float* i) {
  fft2(r[0], i[0], r[2], i[2]);
  fft2(r[1], i[1], r[3], i[3]);
  const float t = r[3];  // (u1 - u3) * -i
  r[3] = i[3];
  i[3] = -t;
  fft2(r[0], i[0], r[1], i[1]);  // U0, U2
  fft2(r[2], i[2], r[3], i[3]);  // U1, U3
  float s = r[1];
  r[1] = r[2];
  r[2] = s;
  s = i[1];
  i[1] = i[2];
  i[2] = s;
}

// 8-point DFT in place of r[0..7], i[0..7]: a radix-2 split into two
// 4-point DFTs, the odd half turned by W8^1, W8^2 = -i and W8^3 first
__device__ __forceinline__ void fft8(float* r, float* i) {
  constexpr float c = 0.70710678118654752f;
#pragma unroll
  for (int k = 0; k < 4; ++k) fft2(r[k], i[k], r[k + 4], i[k + 4]);
  float t = r[5];
  r[5] = c * (t + i[5]);
  i[5] = c * (i[5] - t);
  t = r[6];
  r[6] = i[6];
  i[6] = -t;
  t = r[7];
  r[7] = c * (i[7] - t);
  i[7] = -c * (t + i[7]);
  fft4(r, i);
  fft4(r + 4, i + 4);
  float sr[8], si[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    sr[k] = r[k];
    si[k] = i[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r[2 * k] = sr[k];
    i[2 * k] = si[k];
    r[2 * k + 1] = sr[k + 4];
    i[2 * k + 1] = si[k + 4];
  }
}

// cos and sin of 2 pi m / r for r = 3, 5, 7 and 0 < m < r, float64 rounded
// to f32 (dsp._C); called with constants, so each folds to an immediate
__device__ __forceinline__ float cos_2pi(int r, int m) {
  switch (r * 8 + m) {
    case 25: return -0.4999999999999998f;
    case 26: return -0.5000000000000004f;
    case 41: return 0.30901699437494745f;
    case 42: return -0.8090169943749473f;
    case 43: return -0.8090169943749476f;
    case 44: return 0.30901699437494723f;
    case 57: return 0.6234898018587336f;
    case 58: return -0.22252093395631434f;
    case 59: return -0.900968867902419f;
    case 60: return -0.9009688679024191f;
    case 61: return -0.2225209339563146f;
    case 62: return 0.6234898018587334f;
  }
  return 1.f;
}

__device__ __forceinline__ float sin_2pi(int r, int m) {
  switch (r * 8 + m) {
    case 25: return 0.8660254037844387f;
    case 26: return -0.8660254037844384f;
    case 41: return 0.9510565162951535f;
    case 42: return 0.5877852522924732f;
    case 43: return -0.587785252292473f;
    case 44: return -0.9510565162951536f;
    case 57: return 0.7818314824680298f;
    case 58: return 0.9749279121818236f;
    case 59: return 0.43388373911755823f;
    case 60: return -0.433883739117558f;
    case 61: return -0.9749279121818236f;
    case 62: return -0.7818314824680299f;
  }
  return 0.f;
}

// R-point DFT in place of r[0..R-1], i[0..R-1] for an odd R (3, 5, 7):
// with s_j and d_j the sum and difference of points j and R - j, outputs k
// and R - k are A_k -+ i B_k, A_k = x_0 + sum_j cos(2 pi jk/R) s_j and
// B_k = sum_j sin(2 pi jk/R) d_j (dsp._odd_dft)
template <int R>
__device__ __forceinline__ void dft_odd(float* r, float* i) {
  constexpr int H = (R - 1) / 2;
  float sr[H], si[H], dr[H], di[H];
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    sr[j - 1] = r[j] + r[R - j];
    si[j - 1] = i[j] + i[R - j];
    dr[j - 1] = r[j] - r[R - j];
    di[j - 1] = i[j] - i[R - j];
  }
  float yr[R], yi[R];
  yr[0] = r[0];
  yi[0] = i[0];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    yr[0] += sr[j];
    yi[0] += si[j];
  }
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float ar = r[0], ai = i[0], br = 0.f, bi = 0.f;
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const float c = cos_2pi(R, j * k % R), s = sin_2pi(R, j * k % R);
      ar += c * sr[j - 1];
      ai += c * si[j - 1];
      br += s * dr[j - 1];
      bi += s * di[j - 1];
    }
    yr[k] = ar + bi;
    yi[k] = ai - br;
    yr[R - k] = ar - bi;
    yi[R - k] = ai + br;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    r[k] = yr[k];
    i[k] = yi[k];
  }
}

// the R-point DFT of the passes: radix 8, 4, 2, 3, 5 or 7
template <int R>
__device__ __forceinline__ void butterfly(float* r, float* i) {
  if constexpr (R == 8) {
    fft8(r, i);
  } else if constexpr (R == 4) {
    fft4(r, i);
  } else if constexpr (R == 2) {
    fft2(r[0], i[0], r[1], i[1]);
  } else {
    dft_odd<R>(r, i);
  }
}

}  // namespace

// Native (OpenMP + SIMD) associated-Legendre / Wigner-d recursion
// kernels for the HEALPix spherical harmonic transforms.
//
// CPU counterpart of the lax.scan in sht.py (_lane_step): the same
// three-term recursion in l with libsharp-style power-of-2^60
// shared-exponent rescaling, verified against the same sympy/scipy
// oracles (tests/test_sht_spin.py exercises both paths). The device
// path stays in JAX; this exists because the dense CPU scan is
// rectangle-shaped, while this loop order exploits the m <= l triangle
// (half the flops), vectorizes across ring blocks (the recursion is
// loop-carried in l, so SIMD must run across lanes), and threads over
// rings/m with OpenMP — the same reason the reference leans on healpy's
// C (healpix.py:126).
//
// Layout conventions (all float32, C-contiguous). Everything indexed by
// (m, l) is stored TRANSPOSED, [m][l], so the inner l-loop reads
// contiguous memory:
//   alpha, beta, gamma  : (L, L)  recursion coefficients indexed [m][l]
//   seed_val, seed_exp  : (L, nh) closed-form seeds per (m, ring)
//   seed_step           : (L,)    int32 l at which lane m seeds
//   z                   : (nh,)   cos(theta) of the northern rings
//   rows                : (S, L, L)   per-stream row factors [s][m][l]
//   acc (synth out)     : (S, L, nh)  sum_l rows[s][m][l] * d_l(m, r)
//   h (anal in)         : (S, L, nh)  per-stream ring projections
//   ys (anal out)       : (S, L, L)   sum_r d_l(m, r) * h[s][m][r], [m][l]
//
// Compile: g++ -O3 -march=native -fopenmp -shared -fPIC -o _sht_native.so _sht_native.cpp

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr float BIG = 1073741824.0f;            // 2^30 threshold (sht.py _BIG)
constexpr float INV_BIG = 1.0f / BIG;           // 2^-30
constexpr float DOWN = 8.673617379884035e-19f;  // 2^-60
constexpr float UP = 1.152921504606847e18f;     // 2^60

constexpr int W = 16; // ring-block width (SIMD lanes)

} // namespace

extern "C" {

// Synthesis: acc[s][m][r] = sum_{l >= seed_step[m]} rows[s][m][l] * d_l(m, r).
// Parallel over ring blocks; vectorized across the W lanes of a block.
void sht_synth(int32_t L, int32_t nh, int32_t S, const float *alpha,
               const float *beta, const float *gamma, const float *seed_val,
               const float *seed_exp, const int32_t *seed_step, const float *z,
               const float *rows, float *acc) {
  if (S > 8) return; // fixed out[8][W] stack buffers; callers guard too
  const int32_t n_blocks = (nh + W - 1) / W;
#pragma omp parallel for schedule(static)
  for (int32_t blk = 0; blk < n_blocks; ++blk) {
    const int32_t r0 = blk * W;
    const int32_t nw = (nh - r0 < W) ? (nh - r0) : W;
    float zr[W], lam[W], lam_prev[W], out[8][W];
    int32_t k[W];
    for (int32_t j = 0; j < W; ++j)
      zr[j] = z[r0 + ((j < nw) ? j : 0)];
    for (int32_t m = 0; m < L; ++m) {
      const int32_t l0 = seed_step[m];
      const size_t mrow = (size_t)m * L;
      const float *sv = seed_val + (size_t)m * nh + r0;
      const float *sk = seed_exp + (size_t)m * nh + r0;
      for (int32_t s = 0; s < S; ++s)
        for (int32_t j = 0; j < W; ++j)
          out[s][j] = 0.0f;
      // seed all lanes at l0 (duplicated edge lanes are discarded below)
      for (int32_t j = 0; j < W; ++j) {
        lam[j] = sv[(j < nw) ? j : 0];
        lam_prev[j] = 0.0f;
        k[j] = (int32_t)sk[(j < nw) ? j : 0];
      }
      for (int32_t l = l0; l < L; ++l) {
        const size_t ml = mrow + l;
        const float a = alpha[ml], b = beta[ml], g = gamma[ml];
        float c[W];
        if (l > l0) {
#pragma omp simd
          for (int32_t j = 0; j < W; ++j) {
            const float rec = (a * zr[j] + b) * lam[j] - g * lam_prev[j];
            lam_prev[j] = lam[j];
            lam[j] = rec;
          }
        }
#pragma omp simd
        for (int32_t j = 0; j < W; ++j) {
          const float av = std::fabs(lam[j]);
          const bool big = av > BIG;
          const bool small = (av < INV_BIG) & (k[j] > 0);
          const float scale = big ? DOWN : (small ? UP : 1.0f);
          lam[j] *= scale;
          lam_prev[j] *= scale;
          k[j] += big ? -1 : (small ? 1 : 0);
          c[j] = (k[j] == 0) ? lam[j] : 0.0f;
        }
        for (int32_t s = 0; s < S; ++s) {
          const float rv = rows[(size_t)s * L * L + ml];
          if (rv != 0.0f) {
#pragma omp simd
            for (int32_t j = 0; j < W; ++j)
              out[s][j] += rv * c[j];
          }
        }
      }
      for (int32_t s = 0; s < S; ++s) {
        float *dst = acc + (size_t)s * L * nh + (size_t)m * nh + r0;
        for (int32_t j = 0; j < nw; ++j)
          dst[j] = out[s][j];
      }
    }
  }
}

// Analysis: ys[s][m][l] = sum_r d_l(m, r) * h[s][m][r].
// Parallel over m; vectorized across ring blocks; S <= 8.
void sht_anal(int32_t L, int32_t nh, int32_t S, const float *alpha,
              const float *beta, const float *gamma, const float *seed_val,
              const float *seed_exp, const int32_t *seed_step, const float *z,
              const float *h, float *ys) {
  if (S > 8) return; // fixed hv[8][W] stack buffers; callers guard too
  const int32_t n_blocks = (nh + W - 1) / W;
#pragma omp parallel for schedule(dynamic, 8)
  for (int32_t m = 0; m < L; ++m) {
    const int32_t l0 = seed_step[m];
    const size_t mrow = (size_t)m * L;
    for (int32_t blk = 0; blk < n_blocks; ++blk) {
      const int32_t r0 = blk * W;
      const int32_t nw = (nh - r0 < W) ? (nh - r0) : W;
      float zr[W], lam[W], lam_prev[W], hv[8][W];
      int32_t k[W];
      for (int32_t j = 0; j < W; ++j)
        zr[j] = z[r0 + ((j < nw) ? j : 0)];
      const float *sv = seed_val + (size_t)m * nh + r0;
      const float *sk = seed_exp + (size_t)m * nh + r0;
      for (int32_t j = 0; j < W; ++j) {
        lam[j] = sv[(j < nw) ? j : 0];
        lam_prev[j] = 0.0f;
        k[j] = (int32_t)sk[(j < nw) ? j : 0];
      }
      for (int32_t s = 0; s < S; ++s) {
        const float *src = h + (size_t)s * L * nh + (size_t)m * nh + r0;
        for (int32_t j = 0; j < W; ++j)
          hv[s][j] = (j < nw) ? src[j] : 0.0f; // padded lanes contribute 0
      }
      for (int32_t l = l0; l < L; ++l) {
        const size_t ml = mrow + l;
        const float a = alpha[ml], b = beta[ml], g = gamma[ml];
        float c[W];
        if (l > l0) {
#pragma omp simd
          for (int32_t j = 0; j < W; ++j) {
            const float rec = (a * zr[j] + b) * lam[j] - g * lam_prev[j];
            lam_prev[j] = lam[j];
            lam[j] = rec;
          }
        }
#pragma omp simd
        for (int32_t j = 0; j < W; ++j) {
          const float av = std::fabs(lam[j]);
          const bool big = av > BIG;
          const bool small = (av < INV_BIG) & (k[j] > 0);
          const float scale = big ? DOWN : (small ? UP : 1.0f);
          lam[j] *= scale;
          lam_prev[j] *= scale;
          k[j] += big ? -1 : (small ? 1 : 0);
          c[j] = (k[j] == 0) ? lam[j] : 0.0f;
        }
        for (int32_t s = 0; s < S; ++s) {
          float dot = 0.0f;
#pragma omp simd reduction(+ : dot)
          for (int32_t j = 0; j < W; ++j)
            dot += c[j] * hv[s][j];
          ys[(size_t)s * L * L + ml] += dot;
        }
      }
    }
  }
}

int32_t sht_native_nthreads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

} // extern "C"

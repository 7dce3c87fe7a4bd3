// Poseidon2-KoalaBear (width 16, s-box x^3, 8 external + 13 internal rounds)
// kernels for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernels of zkmips_tpu/ops/pallas_p2.py:
//   zkm_p2_hash_rows  <- _hash_rows_call (PaddingFreeSponge<16, 8, 8> per row)
//   zkm_p2_compress   <- _compress_call  (TruncatedPermutation<2, 8, 16>)
//   zkm_p2_permute    <- the full-width permutation the FRI proof-of-work
//                        grind needs (zkmips_tpu/stark/pcs.py _grind_device).
//
// Bound: integer issue slots, not bytes.  The sponge over (2^21, 85) rows, the
// compression of 2^20 contiguous pairs and the permutation of 2^18 states run
// at the same rate per permutation although their memory patterns differ, so
// the loads hide behind the arithmetic.  An SM issues 32-bit integer work on
// two pipes of 64 lanes each: the multiplier (IMAD, and at half rate
// IMAD.WIDE and IMAD.HI) and the ALU (IADD3, VIADDMNMX, LOP3, SHF); ptxas
// spreads the plain additions over both.  The only lever is fewer
// instructions per permutation, and what the design does about it:
//   * one thread per row, the 16-word state in registers for the whole
//     sponge: no shuffles, no shared memory; round constants in __constant__
//     memory (every thread reads the same word, which the cache broadcasts);
//   * a modular addition is an add and one VIADDMNMX (add and minimum fused),
//     written as min(r, r - P), not compare and select;
//   * a Montgomery product is a wide multiply, a multiply, a multiply-high,
//     a subtract and one VIADDMNMX; the square inside the s-box skips the
//     correction;
//   * the internal round's diagonal costs no multiply: small integers are
//     additions, the powers 2^-k shifts.
// Sums kept unreduced in 64 bits and folded once per output were measured
// and dropped: fewer instructions, but wide multiply-adds at half rate.
// scripts/bench_poseidon2_sources.py compares versions of this file on one
// card; scripts/int_pipe_microbench.py measures the pipes.
//
// Field elements are Montgomery uint32 (R = 2^32), P = 2^31 - 2^24 + 1.  Every
// word that enters or leaves a function below is canonical (< P) unless its
// comment says otherwise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 0x7F000001u;
constexpr uint32_t MU = 0x81000001u;  // P^{-1} mod 2^32
constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int THREADS = 256;

__constant__ uint32_t c_rc[21][WIDTH];  // 4 external, 13 internal (lane 0), 4 external

// The canonical representative of r < 2P: r - P wraps above r when r < P.
__device__ __forceinline__ uint32_t canon(uint32_t r) { return min(r, r - P); }

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  return canon(a + b);  // a + b < 2P < 2^32
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b) {
  const uint32_t r = a - b;  // in (-P, P), wrapped
  return min(r, r + P);
}

// Montgomery product without the final correction, for a * b < 2^32 * P.
// x - m * P is a multiple of 2^32, so only the high words matter, and of
// m * P only its high word (below P) is needed.  The result is congruent to
// a * b / 2^32 and lies in [1, P + a * b / 2^32], below 2P.
__device__ __forceinline__ uint32_t mont_mul_lazy(uint32_t a, uint32_t b) {
  const uint64_t x = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(x) * MU;
  return static_cast<uint32_t>(x >> 32) - __umulhi(m, P) + P;
}

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  return canon(mont_mul_lazy(a, b));
}

// x^3.  The uncorrected square is below P + P^2 / 2^32 < 1.5P, so its product
// with x is below 1.5 P^2 < 2^32 * P.  The square of an uncorrected word would
// not be safe (4 P^2 > 2^32 * P): x itself must be canonical.
__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  return mont_mul(mont_mul_lazy(x, x), x);
}

// x / 2^K, 1 <= K <= 24.  P = 1 (mod 2^24), so with m = -x mod 2^K the sum
// x + m * P = (x + m) + m * 2^31 - m * 2^24 is a multiple of 2^K, and so is
// each of its three terms; m < 2^K, so the quotient is below P and no term
// leaves 32 bits.
template <int K>
__device__ __forceinline__ uint32_t div_pow2(uint32_t x) {
  const uint32_t m = (0u - x) & ((1u << K) - 1u);
  return ((x + m) >> K) + (m << (31 - K)) - (m << (24 - K));
}

// MDS-light layer: M4 on each 4-lane group (the reference's add chain), then
// each lane adds the sum of its position across the four groups.
__device__ __forceinline__ void external_linear(uint32_t s[WIDTH]) {
#pragma unroll
  for (int g = 0; g < WIDTH; g += 4) {
    const uint32_t s0 = s[g], s1 = s[g + 1], s2 = s[g + 2], s3 = s[g + 3];
    const uint32_t t01 = add_mod(s0, s1);
    const uint32_t t23 = add_mod(s2, s3);
    const uint32_t t0123 = add_mod(t01, t23);
    const uint32_t t01123 = add_mod(t0123, s1);
    const uint32_t t01233 = add_mod(t0123, s3);
    s[g + 3] = add_mod(t01233, add_mod(s0, s0));
    s[g + 1] = add_mod(t01123, add_mod(s2, s2));
    s[g] = add_mod(t01123, t01);
    s[g + 2] = add_mod(t01233, t23);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t sum = add_mod(add_mod(s[k], s[k + 4]), add_mod(s[k + 8], s[k + 12]));
#pragma unroll
    for (int g = 0; g < WIDTH; g += 4) s[g + k] = add_mod(s[g + k], sum);
  }
}

__device__ __forceinline__ void external_round(uint32_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(add_mod(s[i], c_rc[r][i]));
  external_linear(s);
}

// s-box on lane 0, then s[i] = d[i] * s[i] + sum(s) with Plonky3's KoalaBear
// diagonal d = [-2, 1, 2, 1/2, 3, 4, -1/2, -3, -4, 1/2^8, 1/8, 1/2^24, -1/2^8,
// -1/8, -1/16, -1/2^24].  A Montgomery word times a canonical constant is the
// Montgomery word of the product, so no lane needs a multiply.
__device__ __forceinline__ void internal_round(uint32_t s[WIDTH], int r) {
  s[0] = sbox(add_mod(s[0], c_rc[r][0]));
  uint32_t total = s[0];
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) total = add_mod(total, s[i]);
  const uint32_t d0 = add_mod(s[0], s[0]), d2 = add_mod(s[2], s[2]), d4 = add_mod(s[4], s[4]);
  const uint32_t d5 = add_mod(s[5], s[5]), d7 = add_mod(s[7], s[7]), d8 = add_mod(s[8], s[8]);
  s[0] = sub_mod(total, d0);
  s[1] = add_mod(total, s[1]);
  s[2] = add_mod(total, d2);
  s[3] = add_mod(total, div_pow2<1>(s[3]));
  s[4] = add_mod(total, add_mod(d4, s[4]));
  s[5] = add_mod(total, add_mod(d5, d5));
  s[6] = sub_mod(total, div_pow2<1>(s[6]));
  s[7] = sub_mod(total, add_mod(d7, s[7]));
  s[8] = sub_mod(total, add_mod(d8, d8));
  s[9] = add_mod(total, div_pow2<8>(s[9]));
  s[10] = add_mod(total, div_pow2<3>(s[10]));
  s[11] = add_mod(total, div_pow2<24>(s[11]));
  s[12] = sub_mod(total, div_pow2<8>(s[12]));
  s[13] = sub_mod(total, div_pow2<3>(s[13]));
  s[14] = sub_mod(total, div_pow2<4>(s[14]));
  s[15] = sub_mod(total, div_pow2<24>(s[15]));
}

__device__ void permute(uint32_t s[WIDTH]) {
  external_linear(s);
#pragma unroll
  for (int r = 0; r < 4; ++r) external_round(s, r);
#pragma unroll
  for (int r = 4; r < 17; ++r) internal_round(s, r);
#pragma unroll
  for (int r = 17; r < 21; ++r) external_round(s, r);
}

__global__ void hash_rows_kernel(const uint32_t* __restrict__ mat, int64_t n, int64_t w,
                                 uint32_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* src = mat + row * w;
  uint32_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = 0;
  for (int64_t start = 0; start < w; start += RATE) {
    const int64_t chunk = w - start < RATE ? w - start : RATE;
    // overwrite absorb: a short final chunk overwrites only its prefix
#pragma unroll
    for (int i = 0; i < RATE; ++i)
      if (i < chunk) s[i] = src[start + i];
    permute(s);
  }
  uint32_t* dst = out + row * RATE;
#pragma unroll
  for (int i = 0; i < RATE; ++i) dst[i] = s[i];
}

// One permutation per row; the 16-word state is read as two halves, row i of
// `left` and of `right`, each `stride` words apart (a contiguous (n, 16)
// matrix is left = in, right = in + 8, stride 16; a Merkle layer compressed
// in place is the same with digests 2i and 2i + 1 as the halves).
// OUT_W = 8: the 2-to-1 compression; 16: the full permutation.
template <int OUT_W>
__global__ void permute_kernel(const uint32_t* __restrict__ left, const uint32_t* __restrict__ right,
                               int64_t stride, int64_t n, uint32_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* l = left + row * stride;
  const uint32_t* r = right + row * stride;
  uint32_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < RATE; ++i) {
    s[i] = l[i];
    s[RATE + i] = r[i];
  }
  permute(s);
  uint32_t* dst = out + row * OUT_W;
#pragma unroll
  for (int i = 0; i < OUT_W; ++i) dst[i] = s[i];
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

const char* zkm_p2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rc: (21, 16) Montgomery round constants, a host pointer.  Copies them into
// this device's constant memory; returns a cudaError_t.  (The diagonal of the
// internal rounds is not data here: internal_round is written for it.)
int zkm_p2_set_constants(const uint32_t* rc) {
  return static_cast<int>(cudaMemcpyToSymbol(c_rc, rc, sizeof(uint32_t) * 21 * WIDTH));
}

// Device pointers; n >= 1.  Each returns cudaGetLastError() after the launch.
int zkm_p2_hash_rows(const uint32_t* mat, int64_t n, int64_t w, uint32_t* out, void* stream) {
  hash_rows_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(mat, n, w, out);
  return static_cast<int>(cudaGetLastError());
}

// left, right: n rows of 8 words each, `stride` words from one row to the next
int zkm_p2_compress(const uint32_t* left, const uint32_t* right, int64_t stride, int64_t n,
                    uint32_t* out, void* stream) {
  permute_kernel<RATE><<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      left, right, stride, n, out);
  return static_cast<int>(cudaGetLastError());
}

int zkm_p2_permute(const uint32_t* states, int64_t n, uint32_t* out, void* stream) {
  permute_kernel<WIDTH><<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      states, states + RATE, WIDTH, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

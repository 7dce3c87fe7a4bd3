// Poseidon2-KoalaBear (width 16, s-box x^3, 8 external + 13 internal rounds)
// kernels for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the Pallas TPU kernels of zkmips_tpu/ops/pallas_p2.py:
//   zkm_p2_hash_rows  <- _hash_rows_call (PaddingFreeSponge<16, 8, 8> per row)
//   zkm_p2_compress   <- _compress_call  (TruncatedPermutation<2, 8, 16>)
//   zkm_p2_permute    <- the full-width permutation the FRI proof-of-work
//                        grind needs (zkmips_tpu/stark/pcs.py _grind_device).
//
// Bound: integer multiplies.  One permutation is 490 Montgomery products
// (8 external rounds x 16 lanes x 2 for the cube, 13 internal rounds x
// (2 + 16)), each three 32-bit multiplies; the bytes moved (the matrix read
// once, the digests written once) are far below that on an H100.  Design: one
// thread per row, the 16-word state in registers for the whole sponge, round
// constants and the diagonal in __constant__ memory (every thread reads the
// same word at the same time, which the constant cache broadcasts).  Rows
// are read straight from the row-major matrix, which is uncoalesced; staging
// row tiles through shared memory is left for later work.
//
// Field elements are Montgomery uint32 (R = 2^32), p = 2^31 - 2^24 + 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 0x7F000001u;
constexpr uint32_t MU = 0x81000001u;  // P^{-1} mod 2^32
constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int THREADS = 128;

__constant__ uint32_t c_rc[21][WIDTH];  // 4 external, 13 internal (lane 0), 4 external
__constant__ uint32_t c_diag[WIDTH];

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  const uint64_t x = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(x) * MU;
  const uint64_t u = static_cast<uint64_t>(m) * P;
  // x - u is a multiple of 2^32, so only the high words matter
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  const uint32_t uhi = static_cast<uint32_t>(u >> 32);
  const uint32_t r = hi - uhi;
  return hi < uhi ? r + P : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  const uint32_t r = a + b;  // < 2p < 2^32
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  return mont_mul(mont_mul(x, x), x);
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

__device__ __forceinline__ void internal_round(uint32_t s[WIDTH], int r) {
  s[0] = sbox(add_mod(s[0], c_rc[r][0]));
  uint32_t total = s[0];
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) total = add_mod(total, s[i]);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = add_mod(mont_mul(s[i], c_diag[i]), total);
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

// OUT_W = 8: (n, 16) -> (n, 8), the 2-to-1 compression; 16: the full permutation
template <int OUT_W>
__global__ void permute_kernel(const uint32_t* __restrict__ in, int64_t n,
                               uint32_t* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* src = in + row * WIDTH;
  uint32_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = src[i];
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

// rc: (21, 16) Montgomery round constants, diag: (16,), host pointers.
// Copies them into this device's constant memory; returns a cudaError_t.
int zkm_p2_set_constants(const uint32_t* rc, const uint32_t* diag) {
  cudaError_t e = cudaMemcpyToSymbol(c_rc, rc, sizeof(uint32_t) * 21 * WIDTH);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyToSymbol(c_diag, diag, sizeof(uint32_t) * WIDTH));
}

// Device pointers; n >= 1.  Each returns cudaGetLastError() after the launch.
int zkm_p2_hash_rows(const uint32_t* mat, int64_t n, int64_t w, uint32_t* out, void* stream) {
  hash_rows_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(mat, n, w, out);
  return static_cast<int>(cudaGetLastError());
}

int zkm_p2_compress(const uint32_t* pairs, int64_t n, uint32_t* out, void* stream) {
  permute_kernel<RATE><<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(pairs, n, out);
  return static_cast<int>(cudaGetLastError());
}

int zkm_p2_permute(const uint32_t* states, int64_t n, uint32_t* out, void* stream) {
  permute_kernel<WIDTH><<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(states, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

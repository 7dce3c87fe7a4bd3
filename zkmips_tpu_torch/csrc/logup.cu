// A chip's LogUp permutation trace in three launches, for Hopper (sm_90a),
// bound to Python through ctypes (ops/logup_cuda.py).
//
// It replaces no Pallas kernel: the JAX package leaves this work to XLA, the
// running sum as a Hillis-Steele prefix sum (zkmips_tpu/stark/permutation.py
// _prefix_sum; the block form in zkmips_tpu/stark/blocks.py).  The port's
// eager path (stark/permutation.py generate_permutation_trace_eager) issued
// int64 torch launches per lookup and took the running sum with torch.cumsum,
// whose scan of the outer dimension walks the H rows with one thread a
// column.
//
// 1. logup_rows: one thread a row, the rows of a block a tile of THREADS
//    rows, the tiles strided by the grid.  Per row it runs the chip's tape
//    (stark/logup_tape.py): the lookups' values and multiplicities, each
//    denominator D_i = alpha + index + sum_k beta^k v_k from the challenge
//    table; inverts them by the eager path's algorithm (more than 2 lookups:
//    one ext inverse of the running product, then the back-multiplication;
//    otherwise each alone; zero maps to zero either way); sums the signed
//    fractions by chunks straight into the chunk columns of perm_flat; and
//    scans the row sums of the tile in the block (warp shuffles), writing the
//    tile's own running sum into the last column and its total to partials.
//    Values live in slots of a scratch buffer, slot-major (slot s of the
//    thread t at s * rows + t), as in quotient.cu; the wrapper keeps the rows
//    in flight within a budget.
// 2. logup_scan_tiles: one block turns the tiles' totals into their
//    exclusive prefix sums and writes the total, the local cumulative sum.
// 3. logup_add_tiles: each tile's rows add their tile's prefix.
// Bound: the lookup columns read once and perm_flat written once at the
// card's 3.35 TB/s, or the Montgomery products at the integer rate (per row
// the tape's, one ext inverse, the batch products); the products bound the
// chips of fib2.  The design reads the columns once, keeps no int64 (H, 4)
// temporaries and launches three kernels a chip, none of which waits for the
// host.
//
// Field elements are Montgomery uint32 (R = 2^32), P = 2^31 - 2^24 + 1.
// Every value stored is canonical (< P), so every word equals the eager
// path's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 0x7F000001u;
constexpr uint32_t MU = 0x81000001u;  // P^{-1} mod 2^32
constexpr uint32_t MONTY_ONE = 0x01FFFFFEu;  // 2^32 mod P
constexpr int THREADS = 128;  // rows a tile
constexpr int SCAN_THREADS = 1024;
constexpr int INDEX_BITS = 28;
constexpr uint32_t INDEX_MASK = (1u << INDEX_BITS) - 1;

// opcodes and operand kinds: stark/quotient_tape.py, stark/logup_tape.py
enum : int32_t { ADD_BB, SUB_BB, MUL_BB, NEG_B, LK_OPEN = 14, LK_DEN, LK_MULT };
enum : uint32_t { K_BSLOT, K_ESLOT, K_UNI, K_MAIN, K_MAIN_NEXT, K_PREP };

__device__ __forceinline__ uint32_t canon(uint32_t r) { return min(r, r - P); }

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) { return canon(a + b); }

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b) {
  const uint32_t r = a - b;  // in (-P, P), wrapped
  return min(r, r + P);
}

// a * b / 2^32 mod P for canonical a, b (quotient.cu's).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  const uint64_t x = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(x) * MU;
  return canon(static_cast<uint32_t>(x >> 32) - __umulhi(m, P) + P);
}

__device__ __forceinline__ uint32_t mont_pow(uint32_t b, uint32_t e) {
  uint32_t r = MONTY_ONE;
  for (; e; e >>= 1) {
    if (e & 1) r = mont_mul(r, b);
    b = mont_mul(b, b);
  }
  return r;
}

__device__ __forceinline__ uint32_t triple(uint32_t a) { return add_mod(add_mod(a, a), a); }

__device__ __forceinline__ uint32_t dot4(uint32_t a0, uint32_t b0, uint32_t a1, uint32_t b1,
                                         uint32_t a2, uint32_t b2, uint32_t a3, uint32_t b3) {
  return add_mod(add_mod(mont_mul(a0, b0), mont_mul(a1, b1)),
                 add_mod(mont_mul(a2, b2), mont_mul(a3, b3)));
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(add_mod(a.x, b.x), add_mod(a.y, b.y), add_mod(a.z, b.z), add_mod(a.w, b.w));
}

__device__ __forceinline__ uint4 sub4(uint4 a, uint4 b) {
  return make_uint4(sub_mod(a.x, b.x), sub_mod(a.y, b.y), sub_mod(a.z, b.z), sub_mod(a.w, b.w));
}

// F_p[X] / (X^4 - 3): the products that wrap past X^3 take the factor 3 on b.
__device__ __forceinline__ uint4 ext_mul(uint4 a, uint4 b) {
  const uint32_t t1 = triple(b.y), t2 = triple(b.z), t3 = triple(b.w);
  return make_uint4(dot4(a.x, b.x, a.y, t3, a.z, t2, a.w, t1),
                    dot4(a.x, b.y, a.y, b.x, a.z, t3, a.w, t2),
                    dot4(a.x, b.z, a.y, b.y, a.z, b.x, a.w, t3),
                    dot4(a.x, b.w, a.y, b.z, a.z, b.y, a.w, b.x));
}

__device__ __forceinline__ uint4 ext_scale(uint4 a, uint32_t b) {
  return make_uint4(mont_mul(a.x, b), mont_mul(a.y, b), mont_mul(a.z, b), mont_mul(a.w, b));
}

// 1 / a, zero for zero.  With Y = X^2 (Y^2 = 3), a = A + X B for A, B in
// F_p[Y]; a (A - X B) = A^2 - Y B^2 = c0 + c1 Y, whose inverse is
// (c0 - c1 Y) / (c0^2 - 3 c1^2): one base inverse, by a^(P - 2).
__device__ __forceinline__ uint4 ext_inv(uint4 a) {
  const uint32_t c0 = sub_mod(add_mod(mont_mul(a.x, a.x), triple(mont_mul(a.z, a.z))),
                              triple(add_mod(mont_mul(a.y, a.w), mont_mul(a.y, a.w))));
  const uint32_t c1 = sub_mod(add_mod(mont_mul(a.x, a.z), mont_mul(a.x, a.z)),
                              add_mod(mont_mul(a.y, a.y), triple(mont_mul(a.w, a.w))));
  const uint32_t n = sub_mod(mont_mul(c0, c0), triple(mont_mul(c1, c1)));
  const uint32_t n_inv = mont_pow(n, P - 2);
  const uint32_t e0 = mont_mul(c0, n_inv), e1 = sub_mod(0, mont_mul(c1, n_inv));
  // (a0 - a1 X + a2 X^2 - a3 X^3)(e0 + e1 X^2)
  return make_uint4(add_mod(mont_mul(a.x, e0), triple(mont_mul(a.z, e1))),
                    sub_mod(0, add_mod(mont_mul(a.y, e0), triple(mont_mul(a.w, e1)))),
                    add_mod(mont_mul(a.z, e0), mont_mul(a.x, e1)),
                    sub_mod(0, add_mod(mont_mul(a.w, e0), mont_mul(a.y, e1))));
}

__device__ __forceinline__ uint4 shfl_up4(uint4 v, int off) {
  return make_uint4(__shfl_up_sync(0xffffffffu, v.x, off), __shfl_up_sync(0xffffffffu, v.y, off),
                    __shfl_up_sync(0xffffffffu, v.z, off), __shfl_up_sync(0xffffffffu, v.w, off));
}

// The inclusive sum of v over the threads of the block up to this one.
// ``tot`` holds a word a warp; the block's threads all call it.
template <int N>
__device__ __forceinline__ uint4 block_scan(uint4 v, uint4* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const uint4 u = shfl_up4(v, off);
    if (lane >= off) v = add4(v, u);
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint4 w = lane < N / 32 ? tot[lane] : make_uint4(0, 0, 0, 0);
    for (int off = 1; off < 32; off <<= 1) {
      const uint4 u = shfl_up4(w, off);
      if (lane >= off) w = add4(w, u);
    }
    if (lane < N / 32) tot[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = add4(v, tot[warp - 1]);
  __syncthreads();  // ``tot`` is free again
  return v;
}

struct Args {
  const int4* code;
  int64_t n_instr;
  const uint32_t* consts;
  const uint4* chal;  // alpha, beta^0, beta^1, ...
  const uint32_t* main;
  int64_t main_w;
  const uint32_t* prep;
  int64_t prep_w;
  uint32_t* bslots;   // n_base expression slots, then the n_lookups multiplicities
  uint4* eslots;      // the n_lookups denominators, then their running products
  int64_t rows;       // rows in flight: the threads, and the slots' stride
  int64_t n_base;
  int n_lookups;
  int batch_size;
  uint4* perm;        // (h, width) ext words
  int64_t width;
  int64_t h;
  uint4* partials;    // a word a tile
  int64_t n_tiles;
};

__device__ __forceinline__ uint32_t load(const Args& a, const uint32_t* bs, const uint32_t* main_l,
                                         const uint32_t* prep_l, uint32_t op) {
  const uint32_t i = op & INDEX_MASK;
  switch (op >> INDEX_BITS) {
    case K_BSLOT: return bs[i * a.rows];
    case K_UNI: return __ldg(a.consts + i);
    case K_MAIN: return __ldg(main_l + i);
    default: return __ldg(prep_l + i);  // K_PREP
  }
}

__global__ void __launch_bounds__(THREADS) logup_rows(const Args a) {
  __shared__ uint4 tot[THREADS / 32];
  const int64_t t = blockIdx.x * static_cast<int64_t>(THREADS) + threadIdx.x;
  uint32_t* const bs = a.bslots + t;
  uint32_t* const mult = bs + a.n_base * a.rows;
  uint4* const den = a.eslots + t;
  uint4* const pre = den + a.n_lookups * a.rows;
  const int n = a.n_lookups;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int64_t tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int64_t r = tile * THREADS + threadIdx.x;
    uint4* const out = a.perm + r * a.width;
    uint4 sum = zero;
    if (r < a.h) {
      const uint32_t* const main_l = a.main + r * a.main_w;
      const uint32_t* const prep_l = a.prep + r * a.prep_w;
      for (int64_t k = 0; k < a.n_instr; ++k) {
        const int4 ins = __ldg(a.code + k);
        const uint32_t op_a = static_cast<uint32_t>(ins.z), op_b = static_cast<uint32_t>(ins.w);
        const int64_t dst = ins.y * a.rows;
        switch (ins.x) {
          case ADD_BB: bs[dst] = add_mod(load(a, bs, main_l, prep_l, op_a), load(a, bs, main_l, prep_l, op_b)); break;
          case SUB_BB: bs[dst] = sub_mod(load(a, bs, main_l, prep_l, op_a), load(a, bs, main_l, prep_l, op_b)); break;
          case MUL_BB: bs[dst] = mont_mul(load(a, bs, main_l, prep_l, op_a), load(a, bs, main_l, prep_l, op_b)); break;
          case NEG_B: bs[dst] = sub_mod(0, load(a, bs, main_l, prep_l, op_a)); break;
          case LK_OPEN: {
            uint4 d = __ldg(a.chal);
            d.x = add_mod(d.x, load(a, bs, main_l, prep_l, op_a));
            den[dst] = d;
            break;
          }
          case LK_DEN:
            den[dst] = add4(den[dst], ext_scale(__ldg(a.chal + 1 + ins.w), load(a, bs, main_l, prep_l, op_a)));
            break;
          case LK_MULT: {
            const uint32_t m = load(a, bs, main_l, prep_l, op_a);
            mult[dst] = op_b ? sub_mod(0, m) : m;
            break;
          }
          default: break;
        }
      }
      // the inverses of the D_i, last first, times m_i, summed by chunks
      uint4 inv_p = zero;
      if (n > 2) {
        uint4 p = den[0];
        for (int i = 1; i < n; ++i) {
          pre[(i - 1) * a.rows] = p;
          p = ext_mul(p, den[i * a.rows]);
        }
        inv_p = ext_inv(p);
      }
      uint4 col = zero;
      for (int i = n - 1; i >= 0; --i) {
        uint4 inv;
        if (n <= 2) {
          inv = ext_inv(den[i * a.rows]);
        } else if (i > 0) {
          inv = ext_mul(inv_p, pre[(i - 1) * a.rows]);
          inv_p = ext_mul(inv_p, den[i * a.rows]);
        } else {
          inv = inv_p;
        }
        col = add4(col, ext_scale(inv, mult[i * a.rows]));
        if (i % a.batch_size == 0) {
          out[i / a.batch_size] = col;
          sum = add4(sum, col);
          col = zero;
        }
      }
    }
    const uint4 phi = block_scan<THREADS>(sum, tot);
    if (r < a.h) out[a.width - 1] = phi;
    if (threadIdx.x == THREADS - 1) a.partials[tile] = phi;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS) logup_scan_tiles(uint4* partials, int64_t n_tiles,
                                                                  uint4* total) {
  __shared__ uint4 tot[SCAN_THREADS / 32];
  const int64_t per = (n_tiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int64_t lo0 = threadIdx.x * per, lo = lo0 < n_tiles ? lo0 : n_tiles;
  const int64_t hi = lo + per < n_tiles ? lo + per : n_tiles;
  uint4 s = make_uint4(0, 0, 0, 0);
  for (int64_t j = lo; j < hi; ++j) s = add4(s, partials[j]);
  const uint4 incl = block_scan<SCAN_THREADS>(s, tot);
  uint4 run = sub4(incl, s);
  for (int64_t j = lo; j < hi; ++j) {
    const uint4 x = partials[j];
    partials[j] = run;
    run = add4(run, x);
  }
  if (threadIdx.x == SCAN_THREADS - 1) *total = incl;
}

__global__ void __launch_bounds__(THREADS) logup_add_tiles(uint4* perm, int64_t width, int64_t h,
                                                           const uint4* partials) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(THREADS) + threadIdx.x;
  if (r < h) {
    uint4* const phi = perm + r * width + width - 1;
    *phi = add4(*phi, partials[blockIdx.x]);
  }
}

}  // namespace

extern "C" {

const char* zkm_logup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int zkm_logup_threads() { return THREADS; }

// Device pointers (prep may stand in as main's when the tape reads none);
// rows a whole number of tiles, at least one; partials a word a tile of
// THREADS rows.  Launches the three kernels on ``stream``; returns the first
// cudaGetLastError() that is not 0.
int zkm_logup_trace(const int32_t* code, int64_t n_instr, const uint32_t* consts, const uint32_t* chal,
                    const uint32_t* main, int64_t main_w, const uint32_t* prep, int64_t prep_w,
                    uint32_t* bslots, uint32_t* eslots, int64_t rows, int64_t n_base, int64_t n_lookups,
                    int64_t batch_size, uint32_t* perm, int64_t width, int64_t h, uint32_t* partials,
                    uint32_t* total, void* stream) {
  Args a;
  a.code = reinterpret_cast<const int4*>(code);
  a.n_instr = n_instr;
  a.consts = consts;
  a.chal = reinterpret_cast<const uint4*>(chal);
  a.main = main;
  a.main_w = main_w;
  a.prep = prep;
  a.prep_w = prep_w;
  a.bslots = bslots;
  a.eslots = reinterpret_cast<uint4*>(eslots);
  a.rows = rows;
  a.n_base = n_base;
  a.n_lookups = static_cast<int>(n_lookups);
  a.batch_size = static_cast<int>(batch_size);
  a.perm = reinterpret_cast<uint4*>(perm);
  a.width = width;
  a.h = h;
  a.partials = reinterpret_cast<uint4*>(partials);
  a.n_tiles = (h + THREADS - 1) / THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  logup_rows<<<static_cast<unsigned>(rows / THREADS), THREADS, 0, s>>>(a);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  logup_scan_tiles<<<1, SCAN_THREADS, 0, s>>>(a.partials, a.n_tiles, reinterpret_cast<uint4*>(total));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  logup_add_tiles<<<static_cast<unsigned>(a.n_tiles), THREADS, 0, s>>>(a.perm, width, h, a.partials);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The quotient's alpha-folded constraint sum for one chip in one launch, for
// Hopper (sm_90a), bound to Python through ctypes (ops/quotient_cuda.py).
//
// An interpreter over the chip's tape (stark/quotient_tape.py): the
// constraint DAG compiled once to instructions (op, dst, a, b), with the
// base/ext promotions fixed in the opcode.  It replaces no Pallas kernel: the
// JAX package leaves this evaluation to XLA, which fuses the whole DAG
// (zkmips_tpu/stark/blocks.py quotient_chunks_blocked); the port's eager walk
// (stark/air.py fold_constraints) issued a chain of int64 torch launches per
// DAG node and block of rows instead, about 50,000 a shard.
//
// One thread evaluates one row of the quotient domain g * <w_N> at a time, in
// a loop that strides over the rows by the rows in flight; the threads of a
// warp walk the same instruction, read from the tape as one broadcast word.
// Per row:
//   * a Var is read where the LDE left it, at row r or at (r + 2^lqd) mod N;
//   * the selectors come from x = g * w_N^r, carried from row to row by one
//     product: FIRST = Z_H / (x - 1), LAST = Z_H / (x - w_H^-1) from one
//     inversion of their denominators' product, TRANSITION = x - w_H^-1;
//     Z_H(x) and 1/Z_H(x) take 2^lqd values, read from the uniform table;
//   * values live in slots of the scratch buffer, slot-major (slot s of the
//     thread t at s * rows + t), so that a warp touches neighbouring words;
//     an ext slot is one 16-byte word;
//   * the fold's four sums stay in 64-bit registers and are reduced once;
//     the result times 1/Z_H goes straight to chunk r mod 2^lqd, row
//     r >> lqd.
// Bound: the tape's integer work and its slot traffic.  Both are small next
// to the launches they replace; the wrapper's scratch budget keeps the slots
// of the rows in flight within half the L2 cache, so that their round trips
// stay there.
//
// Field elements are Montgomery uint32 (R = 2^32), P = 2^31 - 2^24 + 1.
// Every value stored or read is canonical (< P), so every output word equals
// the eager fold's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P = 0x7F000001u;
constexpr uint32_t MU = 0x81000001u;  // P^{-1} mod 2^32
constexpr uint32_t MONTY_ONE = 0x01FFFFFEu;  // 2^32 mod P
constexpr int THREADS = 128;
constexpr int INDEX_BITS = 28;
constexpr uint32_t INDEX_MASK = (1u << INDEX_BITS) - 1;

// opcodes and operand kinds: stark/quotient_tape.py
enum : int32_t {
  ADD_BB, SUB_BB, MUL_BB, NEG_B, ADD_EE, SUB_EE, MUL_EE, NEG_E,
  ADD_EB, SUB_EB, SUB_BE, MUL_EB, FOLD_B, FOLD_E
};
enum : uint32_t {
  K_BSLOT, K_ESLOT, K_UNI, K_MAIN, K_MAIN_NEXT, K_PREP, K_PREP_NEXT,
  K_PERM, K_PERM_NEXT, K_SEL
};

__device__ __forceinline__ uint32_t canon(uint32_t r) { return min(r, r - P); }

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) { return canon(a + b); }

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b) {
  const uint32_t r = a - b;  // in (-P, P), wrapped
  return min(r, r + P);
}

// a * b / 2^32 mod P for canonical a, b: the high words of x and of m * P
// (x - m * P is a multiple of 2^32), below 2P before the correction.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  const uint64_t x = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(x) * MU;
  return canon(static_cast<uint32_t>(x >> 32) - __umulhi(m, P) + P);
}

__device__ __forceinline__ uint32_t mont_pow(uint32_t b, uint64_t e) {
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

struct Args {
  const int4* tape;
  int64_t n_instr;
  const uint32_t* uni;  // the uniform table
  int64_t inv_zh;       // its offset of 1/Z_H
  const uint32_t* main;
  int64_t main_w;
  const uint32_t* prep;
  int64_t prep_w;
  const uint4* perm;    // ext columns, a row of perm_w
  int64_t perm_w;
  uint32_t* bslots;
  uint4* eslots;
  int64_t rows;         // rows in flight: the threads, and the slots' stride
  int log_n;
  int lqd;
  uint32_t omega;       // w_N
  uint32_t omega_rows;  // w_N^rows
  uint32_t shift;       // g
  uint32_t last;        // w_H^-1
  int invert;           // the tape reads FIRST or LAST
  uint4* out;           // (2^lqd, N >> lqd) ext values
};

// Where one thread's row reads its operands.
struct Row {
  const uint32_t* uni;
  const uint32_t* main_l;
  const uint32_t* main_n;
  const uint32_t* prep_l;
  const uint32_t* prep_n;
  const uint4* perm_l;
  const uint4* perm_n;
  uint32_t* bs;
  uint4* es;
  int64_t rows;
  uint32_t first, last, transition;
};

__device__ __forceinline__ uint32_t load_b(const Row& w, uint32_t op) {
  const uint32_t i = op & INDEX_MASK;
  switch (op >> INDEX_BITS) {
    case K_BSLOT: return w.bs[i * w.rows];
    case K_UNI: return __ldg(w.uni + i);
    case K_MAIN: return __ldg(w.main_l + i);
    case K_MAIN_NEXT: return __ldg(w.main_n + i);
    case K_PREP: return __ldg(w.prep_l + i);
    case K_PREP_NEXT: return __ldg(w.prep_n + i);
    default: return i == 0 ? w.first : (i == 1 ? w.last : w.transition);  // K_SEL
  }
}

__device__ __forceinline__ uint4 load_e(const Row& w, uint32_t op) {
  const uint32_t i = op & INDEX_MASK;
  switch (op >> INDEX_BITS) {
    case K_ESLOT: return w.es[i * w.rows];
    case K_PERM: return __ldg(w.perm_l + i);
    case K_PERM_NEXT: return __ldg(w.perm_n + i);
    default:  // K_UNI
      return make_uint4(__ldg(w.uni + i), __ldg(w.uni + i + 1), __ldg(w.uni + i + 2),
                        __ldg(w.uni + i + 3));
  }
}

__device__ __forceinline__ void fold(uint64_t acc[4], uint4 t) {
  acc[0] += t.x;
  acc[1] += t.y;
  acc[2] += t.z;
  acc[3] += t.w;
}

__global__ void __launch_bounds__(THREADS) fold_kernel(const Args a) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(THREADS) + threadIdx.x;
  if (t >= a.rows) return;
  const int64_t n = int64_t(1) << a.log_n;
  const int64_t mask = (int64_t(1) << a.lqd) - 1;
  const int64_t h = n >> a.lqd;
  Row w;
  w.uni = a.uni;
  w.bs = a.bslots + t;
  w.es = a.eslots + t;
  w.rows = a.rows;
  uint32_t x = mont_mul(a.shift, mont_pow(a.omega, static_cast<uint64_t>(t)));
  for (int64_t r = t; r < n; r += a.rows) {
    const int64_t rn = (r + mask + 1) & (n - 1);
    w.main_l = a.main + r * a.main_w;
    w.main_n = a.main + rn * a.main_w;
    w.prep_l = a.prep + r * a.prep_w;
    w.prep_n = a.prep + rn * a.prep_w;
    w.perm_l = a.perm + r * a.perm_w;
    w.perm_n = a.perm + rn * a.perm_w;
    const uint32_t x_last = sub_mod(x, a.last);
    w.transition = x_last;
    w.first = w.last = 0;
    if (a.invert) {
      const uint32_t zh = __ldg(a.uni + (r & mask));
      const uint32_t x_one = sub_mod(x, MONTY_ONE);
      const uint32_t d = mont_pow(mont_mul(x_one, x_last), P - 2);  // 1 / ((x - 1)(x - last))
      w.first = mont_mul(zh, mont_mul(x_last, d));
      w.last = mont_mul(zh, mont_mul(x_one, d));
    }
    uint64_t acc[4] = {0, 0, 0, 0};
    for (int64_t k = 0; k < a.n_instr; ++k) {
      const int4 ins = __ldg(a.tape + k);
      const uint32_t op_a = static_cast<uint32_t>(ins.z), op_b = static_cast<uint32_t>(ins.w);
      uint32_t* const bd = w.bs + ins.y * w.rows;
      uint4* const ed = w.es + ins.y * w.rows;
      switch (ins.x) {
        case ADD_BB: *bd = add_mod(load_b(w, op_a), load_b(w, op_b)); break;
        case SUB_BB: *bd = sub_mod(load_b(w, op_a), load_b(w, op_b)); break;
        case MUL_BB: *bd = mont_mul(load_b(w, op_a), load_b(w, op_b)); break;
        case NEG_B: *bd = sub_mod(0, load_b(w, op_a)); break;
        case ADD_EE: {
          const uint4 u = load_e(w, op_a), v = load_e(w, op_b);
          *ed = make_uint4(add_mod(u.x, v.x), add_mod(u.y, v.y), add_mod(u.z, v.z), add_mod(u.w, v.w));
          break;
        }
        case SUB_EE: {
          const uint4 u = load_e(w, op_a), v = load_e(w, op_b);
          *ed = make_uint4(sub_mod(u.x, v.x), sub_mod(u.y, v.y), sub_mod(u.z, v.z), sub_mod(u.w, v.w));
          break;
        }
        case MUL_EE: *ed = ext_mul(load_e(w, op_a), load_e(w, op_b)); break;
        case NEG_E: {
          const uint4 u = load_e(w, op_a);
          *ed = make_uint4(sub_mod(0, u.x), sub_mod(0, u.y), sub_mod(0, u.z), sub_mod(0, u.w));
          break;
        }
        case ADD_EB: {
          uint4 u = load_e(w, op_a);
          u.x = add_mod(u.x, load_b(w, op_b));
          *ed = u;
          break;
        }
        case SUB_EB: {
          uint4 u = load_e(w, op_a);
          u.x = sub_mod(u.x, load_b(w, op_b));
          *ed = u;
          break;
        }
        case SUB_BE: {
          const uint32_t s = load_b(w, op_a);
          const uint4 u = load_e(w, op_b);
          *ed = make_uint4(sub_mod(s, u.x), sub_mod(0, u.y), sub_mod(0, u.z), sub_mod(0, u.w));
          break;
        }
        case MUL_EB: *ed = ext_scale(load_e(w, op_a), load_b(w, op_b)); break;
        case FOLD_B: {
          const uint4 apow = load_e(w, (K_UNI << INDEX_BITS) | static_cast<uint32_t>(ins.y));
          fold(acc, ext_scale(apow, load_b(w, op_a)));
          break;
        }
        case FOLD_E: {
          const uint4 apow = load_e(w, (K_UNI << INDEX_BITS) | static_cast<uint32_t>(ins.y));
          fold(acc, ext_mul(load_e(w, op_a), apow));
          break;
        }
        default: break;
      }
    }
    const uint32_t inv_zh = __ldg(a.uni + a.inv_zh + (r & mask));
    a.out[(r & mask) * h + (r >> a.lqd)] = make_uint4(
        mont_mul(static_cast<uint32_t>(acc[0] % P), inv_zh), mont_mul(static_cast<uint32_t>(acc[1] % P), inv_zh),
        mont_mul(static_cast<uint32_t>(acc[2] % P), inv_zh), mont_mul(static_cast<uint32_t>(acc[3] % P), inv_zh));
    x = mont_mul(x, a.omega_rows);
  }
}

}  // namespace

extern "C" {

const char* zkm_quotient_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int zkm_quotient_threads() { return THREADS; }

// Device pointers (prep and perm may be null when the tape reads neither);
// rows >= 1.  Returns cudaGetLastError() after the launch.
int zkm_quotient_fold(const int32_t* tape, int64_t n_instr, const uint32_t* uni, int64_t inv_zh,
                      const uint32_t* main, int64_t main_w, const uint32_t* prep, int64_t prep_w,
                      const uint32_t* perm, int64_t perm_w, uint32_t* bslots, uint32_t* eslots,
                      int64_t rows, int64_t log_n, int64_t lqd, uint32_t omega, uint32_t omega_rows,
                      uint32_t shift, uint32_t last, int32_t invert, uint32_t* out, void* stream) {
  Args a;
  a.tape = reinterpret_cast<const int4*>(tape);
  a.n_instr = n_instr;
  a.uni = uni;
  a.inv_zh = inv_zh;
  a.main = main;
  a.main_w = main_w;
  a.prep = prep;
  a.prep_w = prep_w;
  a.perm = reinterpret_cast<const uint4*>(perm);
  a.perm_w = perm_w;
  a.bslots = bslots;
  a.eslots = reinterpret_cast<uint4*>(eslots);
  a.rows = rows;
  a.log_n = static_cast<int>(log_n);
  a.lqd = static_cast<int>(lqd);
  a.omega = omega;
  a.omega_rows = omega_rows;
  a.shift = shift;
  a.last = last;
  a.invert = invert;
  a.out = reinterpret_cast<uint4*>(out);
  const int64_t blocks = (rows + THREADS - 1) / THREADS;
  fold_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Issue rates of the 32-bit integer instructions the Poseidon2 kernels are made
// of, measured on the card this runs on.
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -o int_pipe_microbench int_pipe_microbench.cu
//   ./int_pipe_microbench            (scripts/int_pipe_microbench.py builds and runs it)
//
// Each case is a loop of independent dependency chains of one instruction (or
// a fixed mix of two), run by 2048 threads on every SM (16 warps per
// scheduler, each with four chains in flight: enough to hide the latency).
// The time is taken with CUDA events around one launch of about a millisecond;
// the rate is PTX operations per second over all lanes of the card, and the
// same per SM and clock at the clock the device reports (132 SMs x 64 lanes x
// 1.98 GHz = 16.7 x 10^12/s is one half-rate pipe).  The PTX is explicit, but
// ptxas chooses the machine instructions and merges some: read a line
// against the disassembly (cuobjdump -sass) of its kernel.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

constexpr int CHAINS = 4;
constexpr int ITERS = 16384;
constexpr int THREADS = 1024;
constexpr int BLOCKS_PER_SM = 2;

enum Case { IMAD, IMAD_WIDE, IMAD_HI, IADD, ADD_MIN, MIN, LOP, SHF, ADD64,
            MIX_IMAD_IADD, MIX_IMAD_ADDMIN, MIX_WIDE_IADD, MIX_HI_IADD, MIX_IMAD_WIDE, N_CASES };
const char* const NAMES[N_CASES] = {
    "mad.lo.u32", "mul.wide.u32 (+ xor of the high word)", "mad.hi.u32", "add.u32", "add.u32 + min.u32", "min.u32 + max.u32", "lop3.b32",
    "shf.r.wrap.b32", "add.u64", "mad.lo + add (1:1)", "mad.lo + (add + min) (1:1:1)",
    "mad.wide + add (1:1)", "mad.hi + add (1:1)", "mad.lo + mad.wide (1:1)"};
// PTX operations per chain step, to turn steps into lane-operations
const int OPS[N_CASES] = {1, 1, 1, 2, 2, 2, 2, 1, 2, 2, 3, 2, 2, 2};

template <int CASE>
__device__ __forceinline__ void step(uint32_t& x, uint32_t& y, uint64_t& w, uint32_t a, uint32_t b) {
  if (CASE == IMAD) asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(a), "r"(b));
  if (CASE == IMAD_WIDE) {  // the low word is the next multiplicand, the high word is kept alive
    asm volatile("mul.wide.u32 %0, %1, %2;" : "=l"(w) : "r"(x), "r"(a));
    x = static_cast<uint32_t>(w);
    y ^= static_cast<uint32_t>(w >> 32);
  }
  if (CASE == IMAD_HI) asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(a), "r"(b));
  if (CASE == IADD) {  // each sum feeds the next, so that no two can be merged
    asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
    asm volatile("add.u32 %0, %0, %1;" : "+r"(y) : "r"(x));
  }
  if (CASE == ADD_MIN) {
    uint32_t t;
    asm volatile("add.u32 %0, %1, %2;" : "=r"(t) : "r"(x), "r"(a));
    asm volatile("min.u32 %0, %1, %0;" : "+r"(x) : "r"(t));
  }
  if (CASE == MIN) {
    asm volatile("min.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
    asm volatile("max.u32 %0, %0, %1;" : "+r"(y) : "r"(x));
  }
  if (CASE == LOP) {
    asm volatile("lop3.b32 %0, %0, %1, %2, 0xE8;" : "+r"(x) : "r"(y), "r"(a));
    asm volatile("lop3.b32 %0, %0, %1, %2, 0xE8;" : "+r"(y) : "r"(x), "r"(b));
  }
  if (CASE == SHF) asm volatile("shf.r.wrap.b32 %0, %0, %1, %2;" : "+r"(x) : "r"(y), "r"(b));
  if (CASE == ADD64) asm volatile("add.u64 %0, %0, %1;" : "+l"(w) : "l"(static_cast<uint64_t>(x) << 32 | y));
  if (CASE == MIX_IMAD_IADD) {
    asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(a), "r"(b));
    asm volatile("add.u32 %0, %0, %1;" : "+r"(y) : "r"(x));
  }
  if (CASE == MIX_IMAD_ADDMIN) {
    uint32_t t;
    asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(a), "r"(b));
    asm volatile("add.u32 %0, %1, %2;" : "=r"(t) : "r"(y), "r"(x));
    asm volatile("min.u32 %0, %1, %0;" : "+r"(y) : "r"(t));
  }
  if (CASE == MIX_WIDE_IADD) {
    asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(w) : "r"(x), "r"(a));
    asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(y));
  }
  if (CASE == MIX_HI_IADD) {
    asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(a), "r"(b));
    asm volatile("add.u32 %0, %0, %1;" : "+r"(y) : "r"(x));
  }
  if (CASE == MIX_IMAD_WIDE) {
    asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x) : "r"(a), "r"(b));
    asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(w) : "r"(x), "r"(a));
  }
}

template <int CASE>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    bench(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  const uint32_t a = in[0], b = in[1];
  uint32_t x[CHAINS], y[CHAINS];
  uint64_t w[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    x[c] = in[2 + c] + threadIdx.x;
    y[c] = in[6 + c] ^ threadIdx.x;
    w[c] = static_cast<uint64_t>(x[c]) * y[c];
  }
#pragma unroll 1
  for (int it = 0; it < ITERS; it += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) step<CASE>(x[c], y[c], w[c], a, b);
  }
  uint32_t acc = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc ^= x[c] ^ y[c] ^ static_cast<uint32_t>(w[c]) ^ static_cast<uint32_t>(w[c] >> 32);
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <int CASE>
void run(const uint32_t* in, uint32_t* out, int sms, int clock_khz) {
  float ms = 0;
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  for (int rep = 0; rep < 3; ++rep) {  // the first runs warm up; the last is reported
    cudaEventRecord(start);
    bench<CASE><<<sms * BLOCKS_PER_SM, THREADS>>>(in, out);
    cudaEventRecord(stop);
    cudaEventSynchronize(stop);
    cudaEventElapsedTime(&ms, start, stop);
  }
  const double ops = static_cast<double>(sms) * THREADS * BLOCKS_PER_SM * ITERS * CHAINS * OPS[CASE];
  const double per_s = ops / (ms * 1e-3);
  printf("{\"case\": \"%s\", \"ms\": %.4f, \"tera_lane_ops_per_s\": %.3f, \"per_sm_per_clock\": %.1f}\n",
         NAMES[CASE], ms, per_s * 1e-12, per_s / (static_cast<double>(sms) * clock_khz * 1e3));
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "int_pipe_microbench: no CUDA device\n");
    return 2;
  }
  const int sms = prop.multiProcessorCount;
  printf("{\"device\": \"%s\", \"sms\": %d, \"clock_khz\": %d}\n", prop.name, sms, prop.clockRate);
  uint32_t host[10];
  for (int i = 0; i < 10; ++i) host[i] = 0x9E3779B9u * (i + 1) | 1u;
  uint32_t *in, *out;
  cudaMalloc(&in, sizeof(host));
  cudaMalloc(&out, sizeof(uint32_t) * sms * BLOCKS_PER_SM * THREADS);
  cudaMemcpy(in, host, sizeof(host), cudaMemcpyHostToDevice);
  run<IMAD>(in, out, sms, prop.clockRate);
  run<IMAD_WIDE>(in, out, sms, prop.clockRate);
  run<IMAD_HI>(in, out, sms, prop.clockRate);
  run<IADD>(in, out, sms, prop.clockRate);
  run<ADD_MIN>(in, out, sms, prop.clockRate);
  run<MIN>(in, out, sms, prop.clockRate);
  run<LOP>(in, out, sms, prop.clockRate);
  run<SHF>(in, out, sms, prop.clockRate);
  run<ADD64>(in, out, sms, prop.clockRate);
  run<MIX_IMAD_IADD>(in, out, sms, prop.clockRate);
  run<MIX_IMAD_ADDMIN>(in, out, sms, prop.clockRate);
  run<MIX_WIDE_IADD>(in, out, sms, prop.clockRate);
  run<MIX_HI_IADD>(in, out, sms, prop.clockRate);
  run<MIX_IMAD_WIDE>(in, out, sms, prop.clockRate);
  const cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) {
    fprintf(stderr, "int_pipe_microbench: %s\n", cudaGetErrorString(e));
    return 1;
  }
  return 0;
}

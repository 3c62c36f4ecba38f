// Counter-based random numbers: JAX's threefry2x32 key folds and uniform
// draws, one launch a draw.
//
// Replaces no TPU kernel: the JAX package draws with jax.random under jit,
// where XLA fuses the threefry into its neighbours. The port drew the same
// bits with plain int64 torch ops, 20 rounds of add, mask, shift, or and xor
// a block, each op a launch: ~560 launches and ~90% of the fused pools'
// device time an iteration. Plain-torch twin: pathtrace_tpu_torch/utils/
// rng.py (threefry2x32, fold_in, per_slot_uniforms, bits_to_unit_float,
// bits_to_unit_double), which the CPU takes and which is the bitwise check.
//
// Every random decision has the coordinate (pixel, sample, bounce, slot):
// a lane's key is fold_in(fold_in(fold_in(base, pixel), sample), bounce),
// and slot s of its draw is the threefry block of the counter (0, s) under
// that key. Keys are pairs of 32-bit words; the torch side carries them in
// int64 tensors masked to 32 bits, which is what this file reads and writes.
// Data folded in is taken modulo 2**32, as the twin's `data & 0xFFFFFFFF`.
//
// Entry points (one thread a lane, 256 lanes a block):
//   pt_rng_pool_uniforms(_f64): the pool's draw, from the base key's two
//     words, pixel (int64), sample (int64) and bounce (int32), 3 folds and 9
//     slot blocks, into the (9, S) uniforms;
//   pt_rng_bounce_uniforms(_f64): the wave's draw, from per-lane keys and one
//     bounce for all lanes, 1 fold and 9 slot blocks, into (9, N);
//   pt_rng_fold: one or two folds of per-lane data (or one value for all
//     lanes) under per-lane or scalar keys, into the (2, N) key words.
// The slot rows are stored one after the other, so each store is coalesced
// across a warp. float32 takes the top 23 bits of w0 ^ w1 as a mantissa in
// [1, 2), minus 1 (JAX draws 32 bits); float64 the top 52 of the 64-bit word
// (w0 << 32) | w1. Integers only up to that subtraction, which is exact.
//
// What bounds it on the H100: the INT32 pipe. A block is 20 rounds of add,
// rotate and xor; ptxas issues most adds as IMAD on the FMA pipe, and the
// rotations (funnel shifts) and xors, 40 a block, only the INT32 pipe runs.
// So a pool lane's 12 blocks hold ~480 INT32-pipe operations against 56
// bytes of traffic (float32): ~15 us of that pipe (64 lanes a clock on each
// of 132 SMs at 1.98 GHz) against ~9 us of HBM for the 524,288 lanes of a
// 1080p pool. Measured 0.023 ms queued against the torch twin's 7.4 ms
// (NVIDIA H100 80GB HBM3, 700 W). The folds of one lane are a dependent
// chain; its 9 slot blocks are independent, which gives each thread the
// parallelism to hide that chain's latency.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 9;               // utils/rng.py :: NUM_SLOTS
constexpr uint32_t kParity = 0x1BD11BDA;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// Four rounds of one rotation schedule: x0 += x1; x1 = rotl(x1, r) ^ x0.
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// Threefry-2x32, 20 rounds, of the counter (x0, x1) under the key (k0, k1),
// with JAX's key schedule: the third key word k0 ^ k1 ^ 0x1BD11BDA and the
// injection number (i + 1) after each group of four rounds.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0; x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
}

// jax.random.fold_in: the key becomes the block of the counter (0, data).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1, uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

__device__ __forceinline__ float unit(uint32_t w0, uint32_t w1, float*) {
  return __uint_as_float(((w0 ^ w1) >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ double unit(uint32_t w0, uint32_t w1, double*) {
  const uint64_t mant = (static_cast<uint64_t>(w0) << 20) | (w1 >> 12) | 0x3FF0000000000000ull;
  return __longlong_as_double(static_cast<long long>(mant)) - 1.0;
}

// The 9 slot draws of lane i under its folded key (k0, k1), into u[slot * S + i].
template <typename F>
__device__ __forceinline__ void draw_slots(uint32_t k0, uint32_t k1, F* __restrict__ u, int i,
                                           int S) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(s);
    threefry(k0, k1, x0, x1);
    u[static_cast<size_t>(s) * S + i] = unit(x0, x1, u);
  }
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    rng_pool_uniforms_kernel(const int64_t* __restrict__ key0, const int64_t* __restrict__ key1,
                             const int64_t* __restrict__ pixel,
                             const int64_t* __restrict__ sample, const int* __restrict__ bounce,
                             F* __restrict__ u, int S) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= S) return;
  uint32_t k0 = static_cast<uint32_t>(*key0), k1 = static_cast<uint32_t>(*key1);
  fold_in(k0, k1, static_cast<uint32_t>(pixel[i]));
  fold_in(k0, k1, static_cast<uint32_t>(sample[i]));
  fold_in(k0, k1, static_cast<uint32_t>(bounce[i]));
  draw_slots(k0, k1, u, i, S);
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
    rng_bounce_uniforms_kernel(const int64_t* __restrict__ key0,
                               const int64_t* __restrict__ key1, uint32_t bounce,
                               F* __restrict__ u, int N) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  uint32_t k0 = static_cast<uint32_t>(key0[i]), k1 = static_cast<uint32_t>(key1[i]);
  fold_in(k0, k1, bounce);
  draw_slots(k0, k1, u, i, N);
}

// key_stride 0: one key for every lane; 1: a key a lane. data0 null: value0
// for every lane; data1 null: one fold.
__global__ void __launch_bounds__(kThreads)
    rng_fold_kernel(const int64_t* __restrict__ key0, const int64_t* __restrict__ key1,
                    int key_stride, const int64_t* __restrict__ data0, uint32_t value0,
                    const int64_t* __restrict__ data1, int64_t* __restrict__ out, int N) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  uint32_t k0 = static_cast<uint32_t>(key0[key_stride * i]);
  uint32_t k1 = static_cast<uint32_t>(key1[key_stride * i]);
  fold_in(k0, k1, data0 != nullptr ? static_cast<uint32_t>(data0[i]) : value0);
  if (data1 != nullptr) fold_in(k0, k1, static_cast<uint32_t>(data1[i]));
  out[i] = k0;
  out[N + i] = k1;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

template <typename F>
int launch_pool(const int64_t* key0, const int64_t* key1, const int64_t* pixel,
                const int64_t* sample, const int* bounce, F* u, int S, void* stream) {
  if (S <= 0) return 0;
  rng_pool_uniforms_kernel<F><<<blocks(S), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key0, key1, pixel, sample, bounce, u, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_bounce(const int64_t* key0, const int64_t* key1, long long bounce, F* u, int N,
                  void* stream) {
  if (N <= 0) return 0;
  rng_bounce_uniforms_kernel<F><<<blocks(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key0, key1, static_cast<uint32_t>(bounce), u, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float32 and float64 instances of the two draws; the fold has integers only.
extern "C" int pt_rng_pool_uniforms(const int64_t* key0, const int64_t* key1,
                                    const int64_t* pixel, const int64_t* sample,
                                    const int* bounce, float* u, int S, void* stream) {
  return launch_pool(key0, key1, pixel, sample, bounce, u, S, stream);
}

extern "C" int pt_rng_pool_uniforms_f64(const int64_t* key0, const int64_t* key1,
                                        const int64_t* pixel, const int64_t* sample,
                                        const int* bounce, double* u, int S, void* stream) {
  return launch_pool(key0, key1, pixel, sample, bounce, u, S, stream);
}

extern "C" int pt_rng_bounce_uniforms(const int64_t* key0, const int64_t* key1,
                                      long long bounce, float* u, int N, void* stream) {
  return launch_bounce(key0, key1, bounce, u, N, stream);
}

extern "C" int pt_rng_bounce_uniforms_f64(const int64_t* key0, const int64_t* key1,
                                          long long bounce, double* u, int N, void* stream) {
  return launch_bounce(key0, key1, bounce, u, N, stream);
}

extern "C" int pt_rng_fold(const int64_t* key0, const int64_t* key1, int key_stride,
                           const int64_t* data0, long long value0, const int64_t* data1,
                           int64_t* out, int N, void* stream) {
  if (N <= 0) return 0;
  if (key_stride != 0 && key_stride != 1) return static_cast<int>(cudaErrorInvalidValue);
  rng_fold_kernel<<<blocks(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key0, key1, key_stride, data0, static_cast<uint32_t>(value0), data1, out, N);
  return static_cast<int>(cudaGetLastError());
}

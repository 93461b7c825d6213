// Hand-written Hopper (sm_90a) kernels of the port, behind a plain C interface.
//
// * aged_int8_gemm: int8 (M,K) x int8 (K,N) -> int32 accumulators, with three
//   epilogues chosen by `mode`:
//     0  store the int32 accumulator            (replaces the Pallas kernel
//        repro/kernels/systolic_matmul.py::systolic_matmul, body _matmul_kernel)
//     1  upset the accumulator, store int32     (replaces
//     2  upset, then dequant (acc*xs[r])*ws[c]   repro/kernels/fused_aged_matmul.py
//        and store float32                       ::fused_aged_matmul, _fused_kernel)
//   The upset draws one uint32 per word from the counter stream
//   counter_bits(offset, seed, tile_id) of the reference's interpret path, with
//   tile_id = (r / lbm) * grid_n + c / lbn and offset = (r % lbm) * lbn + c % lbn
//   over the LOGICAL (lbm, lbn) tile the wrapper resolves; grid_n counts the
//   padded grid.  The CTA tile (BM x BN) is independent of it, and ragged edges
//   are masked instead of padded: live words draw exactly the reference's bits.
//   The TPU's on-core PRNG (pltpu.prng_seed) has no counterpart: the counter
//   stream is the stream, so the kernel is bit-exact against the plain version.
// * aged_bitflip: elementwise where(u < q, x ^ (1 << pos), x) over int32 words
//   (replaces repro/kernels/bitflip.py::bitflip_words, body _bitflip_kernel).
//
// What bounds them on an H100: the serve path's GEMMs run at M = 2 (decode) or
// 32 (prefill) against K x N weights of 4-58 MB, so every call is bound by the
// bytes of `b` (58.7 MB for gate/up at 3.35 TB/s is 17.5 us); the operations
// (2*M*K*N) are far below the int8 peak.  This first design streams `b` once
// per CTA column strip through shared memory in 64-deep K slices, packs four
// K-consecutive bytes per column so one __dp4a does four MACs, keeps the
// accumulator in registers across the whole K loop (the systolic array's
// resident partial sums), and applies hash, flip and dequant in registers at
// the flush, so the int32 accumulator never reaches device memory on the fused
// route.  It does not yet overlap loads with compute (no cp.async/TMA ring) and
// has no split-K, so narrow-N decode calls leave most SMs idle; PERF.md has its
// times.  The bitflip pass is bound by its 16 bytes/word of traffic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;        // CTA rows
constexpr int BN = 128;       // CTA columns
constexpr int BK = 64;        // K slice staged in shared memory
constexpr int THREADS = 256;  // 8 warps; warp w owns rows 4w..4w+3
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread

enum Mode : int { kPlain = 0, kUpset = 1, kUpsetDequant = 2 };

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t stream_constant(uint32_t seed,
                                                    uint32_t tile) {
  return fmix32((seed * 0x9E3779B1u) ^ (tile * 0x7FEB352Du));
}

__device__ __forceinline__ uint32_t counter_bits(uint32_t offset, uint32_t seed,
                                                 uint32_t tile) {
  return fmix32((offset * 0x9E3779B9u) ^ stream_constant(seed, tile));
}

// Four consecutive int8 of one row as a little-endian word, zero past `limit`.
__device__ __forceinline__ uint32_t load4(const int8_t* row, int col, int limit,
                                          bool aligned) {
  if (aligned && col + 4 <= limit)
    return __ldg(reinterpret_cast<const uint32_t*>(row + col));
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < limit)
      w |= static_cast<uint32_t>(static_cast<uint8_t>(row[col + i])) << (8 * i);
  return w;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 void* __restrict__ out, int M, int N, int K, uint32_t seed,
                 float q, int lbm, int lbn, int grid_n) {
  // As[r][j]: a[m0+r][k0+4j .. k0+4j+3]; Bs[j][c]: b[k0+4j .. +3][n0+c],
  // both packed four K-consecutive int8 to a word for __dp4a.
  __shared__ uint32_t As[BM][BK / 4];
  __shared__ __align__(16) uint32_t Bs[BK / 4][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 32;
  const int ty = tid / 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bool a_aligned = (K % 4) == 0;
  const bool b_aligned = (N % 4) == 0;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), j = i % (BK / 4);
      const int m = m0 + r;
      As[r][j] = m < M ? load4(a + static_cast<size_t>(m) * K, k0 + 4 * j, K,
                               a_aligned)
                       : 0u;
    }
    for (int i = tid; i < (BK / 4) * (BN / 4); i += THREADS) {
      const int g = i / (BN / 4), quad = i % (BN / 4);
      const int n = n0 + 4 * quad;
      uint32_t rows[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + 4 * g + t;
        rows[t] = k < K ? load4(b + static_cast<size_t>(k) * N, n, N, b_aligned)
                        : 0u;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t w = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) w |= ((rows[t] >> (8 * c)) & 0xFFu) << (8 * t);
        Bs[g][4 * quad + c] = w;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const uint4 bq = *reinterpret_cast<const uint4*>(&Bs[j][tx * TN]);
      const int bv[TN] = {static_cast<int>(bq.x), static_cast<int>(bq.y),
                          static_cast<int>(bq.z), static_cast<int>(bq.w)};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int av = static_cast<int>(As[ty * TM + i][j]);
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = __dp4a(av, bv[c], acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = n0 + tx * TN + c;
      if (col >= N) continue;
      int v = acc[i][c];
      if (MODE != kPlain) {
        const uint32_t tile = static_cast<uint32_t>(r / lbm) *
                                  static_cast<uint32_t>(grid_n) +
                              static_cast<uint32_t>(col / lbn);
        const uint32_t offset = static_cast<uint32_t>(r % lbm) *
                                    static_cast<uint32_t>(lbn) +
                                static_cast<uint32_t>(col % lbn);
        const uint32_t bits = counter_bits(offset, seed, tile);
        // high 27 bits -> uniform in [0, 1) (rounded to float like the
        // reference), low 5 bits -> the bit position
        const float u = __fmul_rn(__uint2float_rn(bits >> 5), 0x1p-27f);
        if (u < q) v = static_cast<int>(static_cast<uint32_t>(v) ^ (1u << (bits & 31u)));
      }
      const size_t idx = static_cast<size_t>(r) * N + col;
      if (MODE == kUpsetDequant) {
        static_cast<float*>(out)[idx] =
            __fmul_rn(__fmul_rn(static_cast<float>(v), xs[r]), ws[col]);
      } else {
        static_cast<int*>(out)[idx] = v;
      }
    }
  }
}

__global__ void bitflip_kernel(const int* __restrict__ x,
                               const float* __restrict__ u,
                               const int* __restrict__ pos, float q,
                               int* __restrict__ out, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int v = x[i];
  const int p = pos[i];
  if (u[i] < q) {
    // a shift by 32 or more flips nothing, as XLA's shift_left gives 0
    const uint32_t mask = static_cast<uint32_t>(p) < 32u ? (1u << p) : 0u;
    v = static_cast<int>(static_cast<uint32_t>(v) ^ mask);
  }
  out[i] = v;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int aged_int8_gemm(const void* a, const void* b, const void* xs, const void* ws,
                   void* out, int M, int N, int K, int mode, uint32_t seed,
                   float q, int lbm, int lbn, int grid_n, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || lbm <= 0 || lbn <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* xsf = static_cast<const float*>(xs);
  const auto* wsf = static_cast<const float*>(ws);
  switch (mode) {
    case kPlain:
      int8_gemm_kernel<kPlain><<<grid, THREADS, 0, s>>>(
          a8, b8, xsf, wsf, out, M, N, K, seed, q, lbm, lbn, grid_n);
      break;
    case kUpset:
      int8_gemm_kernel<kUpset><<<grid, THREADS, 0, s>>>(
          a8, b8, xsf, wsf, out, M, N, K, seed, q, lbm, lbn, grid_n);
      break;
    case kUpsetDequant:
      if (xs == nullptr || ws == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      int8_gemm_kernel<kUpsetDequant><<<grid, THREADS, 0, s>>>(
          a8, b8, xsf, wsf, out, M, N, K, seed, q, lbm, lbn, grid_n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int aged_bitflip(const void* x, const void* u, const void* pos, float q,
                 void* out, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kBlock = 256;
  const long long blocks = (n + kBlock - 1) / kBlock;
  bitflip_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<const float*>(u),
      static_cast<const int*>(pos), q, static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

const char* aged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

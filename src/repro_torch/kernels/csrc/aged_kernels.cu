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
//   padded grid.  The CTA tile is independent of it, and ragged edges are
//   masked instead of padded: live words draw exactly the reference's bits.
//   The TPU's on-core PRNG (pltpu.prng_seed) has no counterpart: the counter
//   stream is the stream, so the kernel is bit-exact against the plain version.
// * aged_bitflip: elementwise where(u < q, x ^ (1 << pos), x) over int32 words
//   (replaces repro/kernels/bitflip.py::bitflip_words, body _bitflip_kernel).
//
// What bounds the GEMM on an H100: the serve path runs it at M = 2 (decode) or
// 32 (prefill) against K x N weights of 4-58 MB, so every call is bound by the
// bytes of `b` (58.7 MB for gate/up at 3.35 TB/s is 17.5 us); the operations
// (2*M*K*N) are far below the int8 tensor-core peak.  Reaching that bound needs
// every SM streaming `b` with enough bytes in flight (~2-3 MB device-wide by
// Little's law), and an inner loop that keeps up.  The fast path
// (int8_gemm_tc_kernel: K and N multiples of 16, 16-byte aligned operands,
// which every serve-path shape is) does that with:
//  - split-K, planned on the host (kernels/_cuda.py::gemm_plan): K is cut into
//    `splits` ranges of whole 128-deep stages so that even N = 1024 launches a
//    CTA per SM.  Each CTA of a split tile stores its int32 partial to a
//    workspace and takes a ticket; the CTA that draws the last ticket adds the
//    partials (int32 addition is exact in any order), runs the epilogue once
//    per word and resets the ticket, so a reused workspace needs no memset.
//    A split costs a partial's round trip and a ticket, so the plan splits
//    only as far as filling the SMs needs (gate/up, 224 column tiles, not at
//    all);
//  - a 4-stage ring of 16-byte cp.async.cg copies (8 KB of `b` per stage in a
//    64-column tile), so three stages are in flight while the tensor cores
//    work on the oldest one;
//  - mma.sync m16n8k32 s8 tensor cores with a 16-row M tile at decode.  Int8 MMA
//    wants `b` K-major, but `b` is N-contiguous and sm_90 has no 8-bit
//    ldmatrix.trans: each thread loads four k rows of four columns from shared
//    memory and transposes the 4x4 bytes with __byte_perm.  Columns are
//    permuted so that each thread ends up with eight consecutive output
//    columns, written with two 16-byte stores; shared-memory chunks are
//    XOR-swizzled so the fragment loads have no bank conflicts.  Two warp
//    groups share each stage's k steps and then each flushes half the rows;
//  - hash, flip and dequant in registers at the flush, with the scales
//    fetched before the main loop: neither the int32 accumulator nor a random
//    bit reaches device memory on the fused route (split partials are int32
//    sums, not results).
// What is left off the bound is a fixed cost of a few microseconds per launch
// (launch, the first round trip to device memory, the ticket, the flush): it
// weighs on the small q/o and k/v shapes, not on gate/up and down (PERF.md
// has the times and the fit).
// The generic path (int8_gemm_kernel: the first design, __dp4a over 64-deep
// slices loaded synchronously, no split) masks every edge and takes the
// shapes the fast path does not.  The bitflip pass is bound by its 16
// bytes/word of traffic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode : int { kPlain = 0, kUpset = 1, kUpsetDequant = 2 };
enum Path : int { kGeneric = 0, kFast = 1 };

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

// Flip bit (bits & 31) of v where the draw's high 27 bits, as a float in
// [0, 1) rounded like the reference, fall below q.
__device__ __forceinline__ int flip_word(int v, uint32_t bits, float q) {
  const float u = __fmul_rn(__uint2float_rn(bits >> 5), 0x1p-27f);
  return u < q ? static_cast<int>(static_cast<uint32_t>(v) ^ (1u << (bits & 31u)))
               : v;
}

// Word (r, col) at its flush, drawn from its logical tile's stream.
__device__ __forceinline__ int upset_word(int v, int r, int col, uint32_t seed,
                                          float q, int lbm, int lbn,
                                          int grid_n) {
  const uint32_t tile =
      static_cast<uint32_t>(r / lbm) * static_cast<uint32_t>(grid_n) +
      static_cast<uint32_t>(col / lbn);
  const uint32_t offset =
      static_cast<uint32_t>(r % lbm) * static_cast<uint32_t>(lbn) +
      static_cast<uint32_t>(col % lbn);
  return flip_word(v, counter_bits(offset, seed, tile), q);
}

// --------------------------------------------------------------------------
// Generic path: any shape, every edge masked.
namespace generic {

constexpr int BM = 32;        // CTA rows
constexpr int BN = 128;       // CTA columns
constexpr int BK = 64;        // K slice staged in shared memory
constexpr int THREADS = 256;  // 8 warps; warp w owns rows 4w..4w+3
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread

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
  // word loads need 4-byte aligned rows: a row stride and a base both
  // multiples of 4
  const bool a_aligned = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0;
  const bool b_aligned = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 4 == 0;

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
      if (MODE != kPlain) v = upset_word(v, r, col, seed, q, lbm, lbn, grid_n);
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

}  // namespace generic

// --------------------------------------------------------------------------
// Fast path: cp.async ring, int8 tensor cores, split-K with a ticket per tile.
namespace tc {

constexpr int BK = 128;           // K bytes per pipeline stage
constexpr int A_PITCH = BK + 16;  // padded `a` row: conflict-free fragment loads

// CTA tile BM x BN: WN = BN / 32 warps across the columns, each repeated
// WK = 2 times to split every stage's four 32-deep k steps; a ring of STAGES
// stages.  (On the serve path's shapes, 8 stages or WK = 1 measured no
// faster.)
template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WK = 2, STAGES = 4;
  static constexpr int WN = BN / 32;
  static constexpr int OWNERS = 32 * WN;  // threads of one warp group
  static constexpr int THREADS = OWNERS * WK;
  static constexpr int MT = BM / 16;      // m16 MMA tiles per warp
  static constexpr int B_BYTES = BK * BN;
  static constexpr int STAGE_BYTES = B_BYTES + BM * A_PITCH;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(WK == 2, "two warp groups: one per half of the m16 rows");
  static_assert(2 * MT * 4 * OWNERS * 8 <= SMEM, "the exchange fits the ring");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  // src-size 0 zero-fills the chunk and reads nothing
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte offset of the 16-byte chunk c (columns 16c .. 16c+15) of k row k in a
// `b` stage.  A stage is 128-byte rows holding one k row (BN = 128) or two
// (BN = 64: odd k in chunks 4..7), with the chunks XOR-swizzled by bits 2-3 of
// k, so that the fragment loads of a warp (four k rows by eight 4-byte
// columns) fall in 32 distinct banks.
template <int BN>
__device__ __forceinline__ int b_chunk(int k, int c) {
  const int row = BN == 128 ? k : k >> 1;
  const int chunk = BN == 128 ? c : (((k & 1) << 2) | c);
  return row * 128 + ((chunk ^ (((k >> 2) & 3) << 1)) << 4);
}

// Start the copies of stage k0 .. k0+BK of `a` rows m0.. and `b` columns n0..
template <class T>
__device__ __forceinline__ void load_stage(uint8_t* stage,
                                           const int8_t* __restrict__ a,
                                           const int8_t* __restrict__ b, int M,
                                           int N, int K, int m0, int n0,
                                           int k0) {
  constexpr int BC = T::BN / 16;          // chunks per `b` row
  constexpr int AC = BK / 16;             // chunks per `a` row
  constexpr int A_CHUNKS = T::BM * AC;
  static_assert((BK * BC) % T::THREADS == 0, "whole `b` copies per thread");
#pragma unroll
  for (int it = 0; it < BK * BC / T::THREADS; ++it) {
    const int i = it * T::THREADS + threadIdx.x;
    const int k = i / BC, c = i % BC;
    const int gk = k0 + k, gn = n0 + 16 * c;
    const bool live = gk < K && gn < N;
    cp_async16(stage + b_chunk<T::BN>(k, c),
               live ? b + static_cast<size_t>(gk) * N + gn : b, live);
  }
  uint8_t* as = stage + T::B_BYTES;
#pragma unroll
  for (int it = 0; it < (A_CHUNKS + T::THREADS - 1) / T::THREADS; ++it) {
    const int i = it * T::THREADS + threadIdx.x;
    if (A_CHUNKS % T::THREADS == 0 || i < A_CHUNKS) {
      const int r = i / AC, c = i % AC;
      const int gm = m0 + r, gk = k0 + 16 * c;
      const bool live = gm < M && gk < K;
      cp_async16(as + r * A_PITCH + 16 * c,
                 live ? a + static_cast<size_t>(gm) * K + gk : a, live);
    }
  }
}

// 4x4 byte transpose: out[c] = byte c of in[0], in[1], in[2], in[3].
__device__ __forceinline__ void transpose4(const uint32_t (&in)[4],
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
  const uint32_t t1 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The MMAs of warp (wn, wk) on one stage: k steps wk*4/WK .. of columns
// 32wn .. 32wn+31.  Thread (g, t) = (lane / 4, lane % 4) builds the B
// fragments of four n8 tiles at once: in n8 tile j, MMA column g is output
// column 32wn + 4g + j, so its four-byte loads (columns 32wn+4g .. +3 of k
// rows kk+4t .. +3) transpose straight into the K-major registers, and its
// accumulators acc[i][j][2h + e] are row 16i + 8h + g, column
// 32wn + 8t + 4e + j: eight consecutive columns per row.
template <class T>
__device__ __forceinline__ void mma_stage(const uint8_t* stage,
                                          int (&acc)[T::MT][4][4], int wn,
                                          int wk, int g, int t) {
  const uint8_t* bs = stage;
  const uint8_t* as = stage + T::B_BYTES;
  const int c = 2 * wn + (g >> 2);
  const int byte = 4 * (g & 3);
  constexpr int STEPS = 4 / T::WK;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int kk = 32 * (wk * STEPS + s);
    uint32_t lo[4], hi[4], b0[4], b1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = lds32(bs + b_chunk<T::BN>(kk + 4 * t + j, c) + byte);
      hi[j] = lds32(bs + b_chunk<T::BN>(kk + 16 + 4 * t + j, c) + byte);
    }
    transpose4(lo, b0);
    transpose4(hi, b1);
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      const uint8_t* ar = as + (16 * i + g) * A_PITCH + kk + 4 * t;
      const uint32_t af[4] = {lds32(ar), lds32(ar + 8 * A_PITCH),
                              lds32(ar + 16), lds32(ar + 8 * A_PITCH + 16)};
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af, b0[j], b1[j]);
    }
  }
}

// grid (ceil(N / BN), ceil(M / BM), splits); split z covers stages
// [z * kblocks / splits, (z + 1) * kblocks / splits) of the kblocks = ceil(K /
// BK) stages.  `partials` holds each split's sums in fragment order (int2 v
// of thread x at v * THREADS + x), `tickets` one counter per tile, zero
// between calls.
template <class T>
__global__ void __launch_bounds__(T::THREADS)
int8_gemm_tc_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    const float* __restrict__ xs, const float* __restrict__ ws,
                    void* __restrict__ out, int2* __restrict__ partials,
                    int* __restrict__ tickets, int M, int N, int K, int splits,
                    int mode, uint32_t seed, float q, int lbm, int lbn,
                    int grid_n) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int last;
  const int owner = threadIdx.x % T::OWNERS, wk = threadIdx.x / T::OWNERS;
  const int wn = owner >> 5, lane = owner & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  const int split = blockIdx.z;
  const int kblocks = (K + BK - 1) / BK;
  const int kb0 = static_cast<int>(static_cast<long long>(split) * kblocks / splits);
  const int nk =
      static_cast<int>(static_cast<long long>(split + 1) * kblocks / splits) - kb0;

  int acc[T::MT][4][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // warp group wk ends with rows 16i + 8wk + g, columns c0 .. c0+7; their
  // scales are fetched now, so the flush does not wait on device memory
  const int c0 = n0 + 32 * wn + 8 * t;  // N % 16 == 0: all eight or none
  float xsv[T::MT], wsv[8];
  if (mode == kUpsetDequant) {
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      const int r = m0 + 16 * i + 8 * wk + g;
      xsv[i] = r < M ? __ldg(xs + r) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) wsv[u] = c0 < N ? __ldg(ws + c0 + u) : 0.f;
  }

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk)
      load_stage<T>(smem + s * T::STAGE_BYTES, a, b, M, N, K, m0, n0,
                    (kb0 + s) * BK);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<T::STAGES - 2>();  // stage i has landed ...
    __syncthreads();  // ... for every thread, and stage i-1 is free again
    const int next = i + T::STAGES - 1;
    if (next < nk)
      load_stage<T>(smem + (next % T::STAGES) * T::STAGE_BYTES, a, b, M, N, K,
                    m0, n0, (kb0 + next) * BK);
    cp_async_commit();
    mma_stage<T>(smem + (i % T::STAGES) * T::STAGE_BYTES, acc, wn, wk, g, t);
  }
  cp_async_wait<0>();

  // The two warp groups of a column strip hold partial sums of the same
  // words.  Through the idle ring, group wk hands the other group the half
  // it will not flush (rows 8h + g for h != wk) and adds the half it gets:
  // sum[i][j] then holds columns c0 + j and c0 + 4 + j of row 16i + 8wk + g.
  int2* xchg = reinterpret_cast<int2*>(smem);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xchg[((1 - wk) * 4 * T::MT + 4 * i + j) * T::OWNERS + owner] =
          wk ? make_int2(acc[i][j][0], acc[i][j][1])
             : make_int2(acc[i][j][2], acc[i][j][3]);
  __syncthreads();
  int2 sum[T::MT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int2 p = xchg[(wk * 4 * T::MT + 4 * i + j) * T::OWNERS + owner];
      sum[i][j] = wk ? make_int2(acc[i][j][2] + p.x, acc[i][j][3] + p.y)
                     : make_int2(acc[i][j][0] + p.x, acc[i][j][1] + p.y);
    }

  if (splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    constexpr int PART = T::MT * 4 * T::THREADS;  // int2 per split partial
    int2* part = partials + static_cast<size_t>(tile) * splits * PART;
    int2* mine = part + static_cast<size_t>(split) * PART;
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        __stcg(mine + (4 * i + j) * T::THREADS + threadIdx.x, sum[i][j]);
    // the CTA's stores, gathered by the barrier, are released by thread 0's
    // fence before its ticket; the last CTA's fence acquires the others'
    // (the arrive/wait pattern of CUTLASS's split-K semaphore)
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(tickets + tile, 1) == splits - 1;
      if (last) {
        tickets[tile] = 0;  // every split has arrived: ready for reuse
        __threadfence();
      }
    }
    __syncthreads();
    if (!last) return;
    // int32 addition is exact in any order; the sum runs in split order
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[i][j] = make_int2(0, 0);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const int2* p = part + static_cast<size_t>(s) * PART + threadIdx.x;
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int2 v = __ldcg(p + (4 * i + j) * T::THREADS);
          sum[i][j].x += v.x;
          sum[i][j].y += v.y;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
    const int r = m0 + 16 * i + 8 * wk + g;
    if (r >= M || c0 >= N) continue;
    int v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = sum[i][j].x;
      v[4 + j] = sum[i][j].y;
    }
    if (mode != kPlain && lbn % 8 == 0) {
      // the eight columns share a logical tile: one stream constant, and
      // word offsets off0 .. off0 + 7
      const uint32_t sc = stream_constant(
          seed, static_cast<uint32_t>(r / lbm) * static_cast<uint32_t>(grid_n) +
                    static_cast<uint32_t>(c0 / lbn));
      const uint32_t off0 =
          static_cast<uint32_t>(r % lbm) * static_cast<uint32_t>(lbn) +
          static_cast<uint32_t>(c0 % lbn);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = flip_word(v[u], fmix32((off0 + u) * 0x9E3779B9u ^ sc), q);
    } else if (mode != kPlain) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = upset_word(v[u], r, c0 + u, seed, q, lbm, lbn, grid_n);
    }
    const size_t idx = static_cast<size_t>(r) * N + c0;
    if (mode == kUpsetDequant) {
      float o[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        o[u] = __fmul_rn(__fmul_rn(static_cast<float>(v[u]), xsv[i]), wsv[u]);
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + idx);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
      int4* dst = reinterpret_cast<int4*>(static_cast<int*>(out) + idx);
      dst[0] = make_int4(v[0], v[1], v[2], v[3]);
      dst[1] = make_int4(v[4], v[5], v[6], v[7]);
    }
  }
}

using LaunchFn = cudaError_t (*)(const int8_t*, const int8_t*, const float*,
                                 const float*, void*, int2*, int*, int, int,
                                 int, int, int, uint32_t, float, int, int, int,
                                 cudaStream_t);

template <class T>
cudaError_t launch(const int8_t* a, const int8_t* b, const float* xs,
                   const float* ws, void* out, int2* partials, int* tickets,
                   int M, int N, int K, int splits, int mode, uint32_t seed,
                   float q, int lbm, int lbn, int grid_n, cudaStream_t s) {
  // above 48 KB a kernel must opt in to its dynamic shared memory, once per
  // device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(int8_gemm_tc_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::SMEM);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < 64) opted_in[dev] = true;
  }
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  int8_gemm_tc_kernel<T><<<grid, T::THREADS, T::SMEM, s>>>(
      a, b, xs, ws, out, partials, tickets, M, N, K, splits, mode, seed, q,
      lbm, lbn, grid_n);
  return cudaGetLastError();
}

// The CTA tiles the plan may choose.
struct Config {
  int bm, bn;
  LaunchFn fn;
};
constexpr Config kConfigs[] = {
    {16, 64, &launch<Tile<16, 64>>},   {16, 128, &launch<Tile<16, 128>>},
    {32, 64, &launch<Tile<32, 64>>},   {32, 128, &launch<Tile<32, 128>>},
    {64, 64, &launch<Tile<64, 64>>},   {64, 128, &launch<Tile<64, 128>>},
};

}  // namespace tc

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

cudaError_t launch_generic(const int8_t* a, const int8_t* b, const float* xs,
                           const float* ws, void* out, int M, int N, int K,
                           int mode, uint32_t seed, float q, int lbm, int lbn,
                           int grid_n, cudaStream_t s) {
  using namespace generic;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  switch (mode) {
    case kPlain:
      int8_gemm_kernel<kPlain><<<grid, THREADS, 0, s>>>(
          a, b, xs, ws, out, M, N, K, seed, q, lbm, lbn, grid_n);
      break;
    case kUpset:
      int8_gemm_kernel<kUpset><<<grid, THREADS, 0, s>>>(
          a, b, xs, ws, out, M, N, K, seed, q, lbm, lbn, grid_n);
      break;
    default:
      int8_gemm_kernel<kUpsetDequant><<<grid, THREADS, 0, s>>>(
          a, b, xs, ws, out, M, N, K, seed, q, lbm, lbn, grid_n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan (path, bm, bn, splits) comes from the host
// (_cuda.py::gemm_plan) and is checked here; `partials` must hold ceil(M/bm) * ceil(N/bn) * splits *
// bm * bn int32 and `tickets` ceil(M/bm) * ceil(N/bn) zeroed int32 when splits
// > 1.  Returns the cudaError_t of the launch (0 on success).
int aged_int8_gemm(const void* a, const void* b, const void* xs, const void* ws,
                   void* out, int M, int N, int K, int mode, uint32_t seed,
                   float q, int lbm, int lbn, int grid_n, int path, int bm,
                   int bn, int splits, void* partials, long long partial_words,
                   void* tickets, long long n_tickets, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K < 0 || lbm <= 0 || lbn <= 0 || mode < kPlain ||
      mode > kUpsetDequant || (mode == kUpsetDequant && (!xs || !ws)))
    return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* xsf = static_cast<const float*>(xs);
  const auto* wsf = static_cast<const float*>(ws);
  if (path == kGeneric) {
    if (bm != generic::BM || bn != generic::BN || splits != 1) return invalid;
    return static_cast<int>(launch_generic(a8, b8, xsf, wsf, out, M, N, K, mode,
                                           seed, q, lbm, lbn, grid_n, s));
  }
  if (path != kFast) return invalid;
  const long long kblocks = (K + tc::BK - 1) / tc::BK;
  const long long tiles =
      static_cast<long long>((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (K % 16 || N % 16 || !aligned || splits < 1 ||
      splits > (kblocks > 1 ? kblocks : 1) || splits > 65535 ||
      (M + bm - 1) / bm > 65535)
    return invalid;
  if (splits > 1 && (!partials || !tickets || n_tickets < tiles ||
                     partial_words < tiles * splits * bm * bn))
    return invalid;
  for (const tc::Config& c : tc::kConfigs)
    if (c.bm == bm && c.bn == bn)
      return static_cast<int>(c.fn(a8, b8, xsf, wsf, out,
                                   static_cast<int2*>(partials),
                                   static_cast<int*>(tickets), M, N, K, splits,
                                   mode, seed, q, lbm, lbn, grid_n, s));
  return invalid;
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

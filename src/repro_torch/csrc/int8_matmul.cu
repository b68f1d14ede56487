// int8 x int8 -> int32 matmul with per-row / per-column float32 scales, on
// the tensor cores.
//
// Replaces repro/kernels/int8_matmul/kernel.py int8_matmul_kernel
// (_int8_mm_kernel): out[m, n] = (float(acc[m, n]) * sx[m]) * sw[n] with
// acc = sum_k x[m, k] * w[k, n] accumulated exactly in int32
// (|acc| <= K * 127^2 < 2^31 for K < 133,000). The epilogue multiplies in
// the reference's order with round-to-nearest and no fused multiply-add, so
// the output equals the plain version's bit for bit. Unlike the Pallas
// kernel, which asserts that M, N and K divide its 128 blocks, every edge
// is masked: token counts such as M = 499 and any N, K work.
//
// Bound on the H100: 2*M*N*K int8 operations against M*K + K*N bytes in and
// 4*M*N bytes out. At the int8 SwiGLU's shapes the bytes bound it: M 499,
// K 1536, N 8960 moves ~32.5 MB (9.7 us at 3.35 TB/s) for 13.7 G
// operations (6.9 us at the data sheet's 1,979 dense int8 TOP/s); M 499,
// K 8960, N 1536 moves ~17.5 MB (5.2 us) for the same operations. The
// design keeps the tensor cores fed from shared memory and the card full:
//   * block tiles of 128 x 128 outputs; 8 consumer warps of 64 x 32 each
//     run the product in mma.sync m16n8k32 s8 x s8 -> s32 (inline PTX) over
//     k-tiles of 128 bytes, while 4 producer warps copy and transpose the
//     tiles of the next k-tiles (a 4-stage ring, handed over by named
//     barriers: "full" when a stage's x and k-major w tiles are ready,
//     "empty" when the consumers are done with it);
//   * x tiles (row-major, k contiguous) and raw w tiles arrive by 16-byte
//     cp.async; x's 16-byte chunks are XOR-swizzled by row so ldmatrix
//     reads the A fragments without bank conflicts;
//   * w is (K, N) with n contiguous, but the s8 mma takes B k-major (.col
//     only). Two k-tiles behind the copies, each producer thread reads
//     4 (k) x 16 (n) blocks of the raw tile, transposes them with
//     __byte_perm into words of 4 k values, and stores them into the
//     k-major tile; words are XOR-swizzled by column so those stores and
//     the consumers' fragment loads are both free of bank conflicts;
//   * where M x N gives fewer 128 x 128 tiles than the card has SMs (K 8960,
//     N 1536: 48), the wrapper splits K across blocks. Splits add their
//     int32 sums atomically into a zeroed workspace (integer addition is
//     exact in any order) and a second launch applies the epilogue once.
// Shapes whose rows are not 16-byte multiples (K or N % 16 != 0, or an
// unaligned base) take the same kernel with byte-wise loads.
#include <cstdint>

#include "common.cuh"

namespace {

// 8 consumer warps (2 rows x 4 columns of 64 x 32 outputs) and 4 producer
// warps that copy and transpose
constexpr int kMmaThreads = 256, kCopyThreads = 128;
constexpr int kThreads = kMmaThreads + kCopyThreads;
constexpr int kBM = 128, kBN = 128, kBK = 128;
constexpr int kStages = 4;  // ring depth: x, raw w and k-major w tiles
constexpr int kLag = 2;     // tiles in flight ahead of the transpose
constexpr int kTileBytes = kBM * kBK;  // every tile is 128 x 128 bytes
constexpr int kSmemBytes = 3 * kStages * kTileBytes;
static_assert(kBM == kBN && kBN == kBK, "every tile is 128 x 128 bytes");
static_assert(kLag <= kStages - 2, "a raw stage is refilled after its "
              "transpose has passed the producers' barrier");
// named barriers (0 is __syncthreads): the producers' own, then per stage
// "full" (x and k-major w tile ready) and "empty" (consumed)
constexpr int kBarCopy = 1, kBarFull = 2, kBarEmpty = kBarFull + kStages;

// epilogue of a block: kScaled writes out, kStore / kAtomic the int32 sums
enum Mode { kScaled = 0, kStore = 1, kAtomic = 2 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// x tile: row m holds its 128 k bytes as 8 chunks of 16, chunk c at slot
// c ^ (m & 7): the 8 rows an ldmatrix reads land in 8 distinct slots.
__device__ __forceinline__ int a_off(int m, int chunk) {
  return m * kBK + ((chunk ^ (m & 7)) << 4);
}
struct XChunk {
  __device__ int operator()(int r, int chunk) const { return a_off(r, chunk); }
};
// raw w tile: k row r holds its 128 n bytes in order
struct RawChunk {
  __device__ int operator()(int r, int chunk) const {
    return r * kBN + chunk * 16;
  }
};
// B tile, k-major: column n holds its 128 k bytes as 32 words of 4, word j
// at j ^ 4 * ((n ^ (n >> 4)) & 7). A fragment load (8 consecutive columns,
// 4 words) and a transposing store (8 columns 16 apart, 4 words) both
// touch 32 distinct banks.
__device__ __forceinline__ int b_off(int n, int word) {
  return n * kBK + ((word ^ (((n ^ (n >> 4)) & 7) << 2)) << 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 32, row-major) * b (32 x 8, column-major), int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of row-major int8 src (`cols` bytes per row) at (r, c), byte
// by byte, zero outside rows x cols
__device__ __forceinline__ uint4 load16_bytes(const int8_t* src, int r, int c,
                                              int rows, int cols) {
  const long long base = static_cast<long long>(r) * cols + c;
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (r < rows) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (c + e < cols)
        w[e >> 2] |= (static_cast<unsigned>(src[base + e]) & 0xFFu)
                     << (8 * (e & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Copy a 128 x 128-byte tile of row-major int8 src (rows r0.., bytes
// c0..; `rows` x `cols`, ld = cols) into shared memory, byte (r, c) at
// off(r, c / 16) + c % 16, zero outside src: 1024 chunks of 16 bytes, 8
// per producer thread, by cp.async (kVec: the row stride and base are
// 16-byte multiples and cols is a multiple of 16, so a chunk is wholly in
// or out) or by byte loads and stores.
template <bool kVec, typename Off>
__device__ __forceinline__ void load_tile(unsigned char* sh,
                                          const int8_t* src, int r0, int c0,
                                          int rows, int cols, int tid,
                                          Off off) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 16 / kCopyThreads; ++i) {
    const int idx = tid + i * kCopyThreads;
    const int r = idx >> 3, chunk = idx & 7;
    const int gr = r0 + r, gc = c0 + chunk * 16;
    if constexpr (kVec) {
      const bool ok = gr < rows && gc < cols;
      cp_async16(sh + off(r, chunk),
                 ok ? src + static_cast<long long>(gr) * cols + gc : src, ok);
    } else {
      *reinterpret_cast<uint4*>(sh + off(r, chunk)) =
          load16_bytes(src, gr, gc, rows, cols);
    }
  }
}

// Transpose this thread's 4 (k) x 16 (n) block of a raw w tile (rows
// 4 kg + i, bytes 16 ng ..) into 16 words (column 16 ng + j holds k values
// 4 kg .. 4 kg + 3, the lowest in its low byte) and store them k-major.
__device__ __forceinline__ void transpose_b(unsigned char* bs,
                                            const unsigned char* raw, int ng,
                                            int kg) {
  uint4 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = *reinterpret_cast<const uint4*>(raw + (4 * kg + i) * kBN + 16 * ng);
  const unsigned a[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
  const unsigned b[4] = {r[1].x, r[1].y, r[1].z, r[1].w};
  const unsigned c[4] = {r[2].x, r[2].y, r[2].z, r[2].w};
  const unsigned d[4] = {r[3].x, r[3].y, r[3].z, r[3].w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // columns 4q .. 4q + 3 of the block
    const unsigned ab_lo = __byte_perm(a[q], b[q], 0x5140);  // a0 b0 a1 b1
    const unsigned ab_hi = __byte_perm(a[q], b[q], 0x7362);  // a2 b2 a3 b3
    const unsigned cd_lo = __byte_perm(c[q], d[q], 0x5140);
    const unsigned cd_hi = __byte_perm(c[q], d[q], 0x7362);
    const unsigned col[4] = {__byte_perm(ab_lo, cd_lo, 0x5410),
                             __byte_perm(ab_lo, cd_lo, 0x7632),
                             __byte_perm(ab_hi, cd_hi, 0x5410),
                             __byte_perm(ab_hi, cd_hi, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<unsigned*>(bs + b_off(16 * ng + 4 * q + j, kg)) =
          col[j];
  }
}

// Fragment layouts of mma m16n8k32 s8 (g = lane / 4, t = lane % 4): A holds
// rows g and g + 8 at k 4t .. 4t + 3 (a0, a1) and 16 + 4t .. (a2, a3); B
// holds column g at k 4t .. (b0) and 16 + 4t .. (b1); the int32 result
// holds row g at columns 2t, 2t + 1 (c0, c1) and row g + 8 (c2, c3).
template <bool kVec, int kMode>
__global__ void __launch_bounds__(kThreads)
int8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ sx, const float* __restrict__ sw,
                float* __restrict__ out, int* __restrict__ acc_out, int M,
                int N, int K, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* a_sh = smem_raw;                       // kStages x tiles
  unsigned char* raw_sh = a_sh + kStages * kTileBytes;  // kStages raw w
  unsigned char* b_sh = raw_sh + kStages * kTileBytes;  // kStages k-major w
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int nkt = min(tiles_per_split, (K + kBK - 1) / kBK - kt0);

  if (tid >= kMmaThreads) {
    // producers: at step j copy tile j (once its stages are empty) and
    // transpose tile j - kLag (once every producer's copies of it landed)
    const int ptid = tid - kMmaThreads;
    for (int j = 0; j < nkt + kLag; ++j) {
      const int st = j % kStages;
      if (j < nkt) {
        if (j >= kStages) bar_sync(kBarEmpty + st, kThreads);
        load_tile<kVec>(a_sh + st * kTileBytes, x, m0, (kt0 + j) * kBK, M, K,
                        ptid, XChunk());
        load_tile<kVec>(raw_sh + st * kTileBytes, w, (kt0 + j) * kBK, n0, K,
                        N, ptid, RawChunk());
      }
      cp_async_commit();  // possibly empty: keeps the group count uniform
      const int tj = j - kLag;
      if (tj < 0) continue;
      cp_async_wait<kLag>();
      bar_sync(kBarCopy, kCopyThreads);
      const int ts = tj % kStages;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // 256 blocks of 4 (k) x 16 (n)
        const int blk = ptid + h * kCopyThreads;
        transpose_b(b_sh + ts * kTileBytes, raw_sh + ts * kTileBytes,
                    blk & 7, blk >> 3);
      }
      bar_arrive(kBarFull + ts, kThreads);
    }
    return;
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // warp tile
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int it = 0; it < nkt; ++it) {
    const int st = it % kStages;
    bar_sync(kBarFull + st, kThreads);
    const unsigned char* as = a_sh + st * kTileBytes;
    const unsigned char* bs = b_sh + st * kTileBytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      unsigned bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn + nt * 8 + g;
        bf[nt][0] = *reinterpret_cast<const unsigned*>(bs + b_off(n, ks * 8 + t));
        bf[nt][1] =
            *reinterpret_cast<const unsigned*>(bs + b_off(n, ks * 8 + 4 + t));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        unsigned af[4];
        const int row = wm + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af, as + a_off(row, ks * 2 + (lane >> 4)));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
    // the producers wait for this stage only to refill it
    if (it + kStages < nkt) bar_arrive(kBarEmpty + st, kThreads);
  }

  const bool pair = (N & 1) == 0;  // 8-byte aligned column pairs
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mt * 16 + g + 8 * h;
      if (m >= M) continue;
      const long long row = static_cast<long long>(m) * N;
      float sxm = 0.f;
      if constexpr (kMode == kScaled) sxm = sx[m];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + nt * 8 + 2 * t;
        const int v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if constexpr (kMode == kScaled) {
          if (n + 1 < N && pair) {
            const float2 o = make_float2(
                __fmul_rn(__fmul_rn(__int2float_rn(v0), sxm), sw[n]),
                __fmul_rn(__fmul_rn(__int2float_rn(v1), sxm), sw[n + 1]));
            *reinterpret_cast<float2*>(out + row + n) = o;
          } else {
            if (n < N)
              out[row + n] = __fmul_rn(__fmul_rn(__int2float_rn(v0), sxm),
                                       sw[n]);
            if (n + 1 < N)
              out[row + n + 1] = __fmul_rn(
                  __fmul_rn(__int2float_rn(v1), sxm), sw[n + 1]);
          }
        } else if constexpr (kMode == kStore) {
          if (n + 1 < N && pair) {
            *reinterpret_cast<int2*>(acc_out + row + n) = make_int2(v0, v1);
          } else {
            if (n < N) acc_out[row + n] = v0;
            if (n + 1 < N) acc_out[row + n + 1] = v1;
          }
        } else {
          if (n < N) atomicAdd(acc_out + row + n, v0);
          if (n + 1 < N) atomicAdd(acc_out + row + n + 1, v1);
        }
      }
    }
  }
}

// The epilogue of a split product, once over the summed accumulators.
constexpr int kScaleThreads = 256;
__global__ void __launch_bounds__(kScaleThreads)
int8_scale_kernel(const int* __restrict__ acc, const float* __restrict__ sx,
                  const float* __restrict__ sw, float* __restrict__ out,
                  int M, int N) {
  const long long total = static_cast<long long>(M) * N;
  for (long long i = blockIdx.x * static_cast<long long>(kScaleThreads) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kScaleThreads) {
    const int m = static_cast<int>(i / N), n = static_cast<int>(i -
                                                static_cast<long long>(m) * N);
    out[i] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), sx[m]), sw[n]);
  }
}

template <bool kVec, int kMode>
cudaError_t launch_mma(const dim3& grid, const int8_t* x, const int8_t* w,
                       const float* sx, const float* sw, float* out,
                       int* acc_out, int M, int N, int K, int per,
                       cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_mma_kernel<kVec, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  int8_mma_kernel<kVec, kMode><<<grid, kThreads, kSmemBytes, s>>>(
      x, w, sx, sw, out, acc_out, M, N, K, per);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t run(const int8_t* x, const int8_t* w, const float* sx,
                const float* sw, float* out, int* acc, int M, int N, int K,
                int splits, cudaStream_t s) {
  const int ktiles = (K + kBK - 1) / kBK;
  const int per = (ktiles + splits - 1) / splits;
  const int nz = (ktiles + per - 1) / per;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, nz);
  if (nz == 1) {
    if (out != nullptr)
      return launch_mma<kVec, kScaled>(grid, x, w, sx, sw, out, nullptr, M,
                                       N, K, per, s);
    return launch_mma<kVec, kStore>(grid, x, w, sx, sw, nullptr, acc, M, N,
                                    K, per, s);
  }
  cudaError_t err = cudaMemsetAsync(
      acc, 0, static_cast<size_t>(M) * N * sizeof(int), s);
  if (err != cudaSuccess) return err;
  err = launch_mma<kVec, kAtomic>(grid, x, w, sx, sw, nullptr, acc, M, N, K,
                                  per, s);
  if (err != cudaSuccess || out == nullptr) return err;
  const long long want =
      (static_cast<long long>(M) * N + kScaleThreads - 1) / kScaleThreads;
  const int blocks = want < 4096 ? static_cast<int>(want) : 4096;
  int8_scale_kernel<<<blocks, kScaleThreads, 0, s>>>(acc, sx, sw, out, M, N);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) int8; w: (K, N) int8; sx: (M,) float32; sw: (N,) float32; all
// contiguous. Writes out (M, N) float32, or, when out is null, the int32
// accumulators into acc_out (M, N) (sx, sw unused). K is cut into at most
// `splits` slices of whole 128-byte k-tiles; with more than one slice,
// acc_out (M, N) int32 is required as the workspace the slices sum into.
TRAPTI_EXPORT int int8_matmul_fwd(const void* x, const void* w,
                                  const void* sx, const void* sw, void* out,
                                  void* acc_out, int M, int N, int K,
                                  int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 ||
      (out == nullptr && acc_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ktiles = (K + kBK - 1) / kBK;
  const int per = (ktiles + splits - 1) / splits;
  if ((ktiles + per - 1) / per > 1 && acc_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  float* op = static_cast<float*>(out);
  int* ap = static_cast<int*>(acc_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaError_t err =
      vec ? run<true>(xp, wp, sxp, swp, op, ap, M, N, K, splits, s)
          : run<false>(xp, wp, sxp, swp, op, ap, M, N, K, splits, s);
  return static_cast<int>(err);
}

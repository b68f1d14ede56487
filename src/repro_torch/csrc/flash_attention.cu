// Prefill attention (GQA) for Hopper, causal or not.
//
// Replaces repro/kernels/flash_attention/kernel.py flash_attention_kernel
// (_flash_kernel), and with it the jnp blocked_attention the reference
// prefill runs (repro/models/attention.py), which computes the same function.
//
// Layout: q (B, S, H, d), k/v (B, T, K, d), out (B, S, H, d), as the model
// produces them; query head h reads KV head h / (H / K). Query row s sits at
// absolute position q_offset + s and attends keys t <= q_offset + s: a
// plain prefill has q_offset 0; a shared or chunked prefill passes the
// m rows already cached (the prefix's keys first in k/v, then the suffix's)
// and computes only the S suffix rows, as the reference's
// blocked_attention(..., q_offset=m) does. With causal = 0 (q_offset 0)
// every query row attends all T keys, for any S and T: the encoder's
// self-attention, and the decoder's cross attention over the encoder
// memory (S != T), as the reference's flash_attention(causal=False) and
// blocked_attention(causal=False) do. Output in the input dtype.
//
// Bound on the H100: at prefill lengths of hundreds of tokens the work is
// O(S^2 d) multiply-adds per head against O(S d) bytes, so it is bound by
// operations. Two kernels, chosen by the wrapper (kernels/flash_attention/
// ops.py) by dtype and head dim:
//
// flash_tc_kernel, bfloat16 with d = 64 or 128, on the tensor cores
// (FlashAttention-2 layout):
//   * one block of four warps per (64-query-row tile, head, batch), each
//     warp owning 16 query rows; the diagonal-most (heaviest) query tiles
//     are launched first, since causal work grows with the tile index
//     (without the mask every tile walks all T keys);
//   * Q K^T and P V through mma.sync m16n8k16 (bf16 in, float32 out), with
//     fragments read by ldmatrix (.trans for V) from bf16 tiles in shared
//     memory whose rows are padded by 16 bytes, so ldmatrix is free of
//     bank conflicts;
//   * K/V tiles of 64 keys, double-buffered with 16-byte cp.async copies;
//     rows past T (and query rows past S) are zero-filled by the copy
//     (src-size 0), never left stale, so 0 x NaN cannot poison a row;
//   * scores are scaled in float32 by log2(e) / sqrt(d) (the wrapper's
//     scale) and the online softmax runs in base 2; m, l and the output
//     accumulators stay in float32 registers; P is rounded to bf16 for
//     P V, as the reference does (attention.py, p.astype(q.dtype));
//   * mma.sync and not wgmma: at S ~ 500 there are at most 8 query tiles
//     per head, under a GFLOP, so the simpler synchronous tiles suffice.
//
// flash_fwd_kernel, float32 (and bf16 with another d <= 128), in float32
// on the CUDA cores (TF32 tensor cores would break float32's tolerance):
//   * one block per (16-query-row tile, head, batch), four warps with four
//     query rows each; the query tile is scaled once into shared memory;
//   * K and V tiles of 32 keys are staged in float32 shared memory with a
//     padded row stride (no bank conflicts when lane j reads key j);
//   * lane j scores key j for the warp's four rows.
//
// Both walk a query row's KV tiles in a fixed order from key 0 upward up
// to the block's last visible key (tiles above the causal diagonal are
// never loaded; without the mask the last key is T - 1), so a row's reduction order depends neither on the prompt
// length nor on the query offset: row r of a prompt equals row r of any
// longer prompt with the same prefix, and the rows of an offset-m call
// equal rows m.. of the offset-0 call over the same keys, bit for bit. A masked score is -1e30 and gives p = 0, so a
// tile wholly past a row's diagonal leaves its m, l and accumulators
// unchanged; the denominator is clamped at 1e-30, as in the reference;
// ragged S is masked, never padded.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per KV tile (one per lane)
constexpr float kNegInf = -1.0e30f;

template <typename T, int DC>  // DC: head dims per lane, d <= 32 * DC
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
                 int H, int K, int d, int q_off, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;  // padded row stride of the K/V tiles
  float* q_sh = smem;               // kBQ * d
  float* k_sh = q_sh + kBQ * d;     // kBK * ld
  float* v_sh = k_sh + kBK * ld;    // kBK * ld

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < kBQ * d; i += kWarps * 32) {
    const int r = i / d, c = i - r * d, s = q0 + r;
    q_sh[i] = s < S ? to_f32(q[(static_cast<size_t>(b) * S + s) * H * d +
                               static_cast<size_t>(h) * d + c]) * scale
                    : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DC; ++i) acc[r][i] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  // keys beyond are above the diagonal of the block's last row
  const int k_end = causal ? min(q_off + q_last + 1, Tk) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_sh is written)
    for (int i = tid; i < kBK * d; i += kWarps * 32) {
      const int j = i / d, c = i - j * d, t = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        const size_t off = (static_cast<size_t>(b) * Tk + t) * K * d +
                           static_cast<size_t>(kh) * d + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_sh[j * ld + c] = kx;
      v_sh[j * ld + c] = vx;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = k_sh + lane * ld;
    const float* qrow = q_sh + warp * kRowsPerWarp * d;
    for (int c = 0; c < d; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] += qrow[r * d + c] * kc;
    }

    const int t = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qs = q0 + warp * kRowsPerWarp + r;
      const float sv =
          (t < Tk && (!causal || t <= q_off + qs)) ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = sv <= kNegInf / 2 ? 0.f : expf(sv - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DC; ++i) acc[r][i] *= corr;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vrow = v_sh + j * ld;
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          const int c = lane + 32 * i;
          if (c < d) acc[r][i] += pj * vrow[c];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qs = q0 + warp * kRowsPerWarp + r;
    if (qs >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + (static_cast<size_t>(b) * S + qs) * H * d +
              static_cast<size_t>(h) * d;
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) orow[c] = from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int K, int d, int q_off,
                   int causal, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  const size_t smem = (kBQ * d + 2 * kBK * (d + 1)) * sizeof(float);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (d <= 32)
    flash_fwd_kernel<T, 1><<<grid, kWarps * 32, smem, stream>>>(qp, kp, vp, op, S, Tk, H, K, d, q_off, causal, scale);
  else if (d <= 64)
    flash_fwd_kernel<T, 2><<<grid, kWarps * 32, smem, stream>>>(qp, kp, vp, op, S, Tk, H, K, d, q_off, causal, scale);
  else if (d <= 128)
    flash_fwd_kernel<T, 4><<<grid, kWarps * 32, smem, stream>>>(qp, kp, vp, op, S, Tk, H, K, d, q_off, causal, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}


// ------------------------------------------- bf16 tensor-core kernel
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBK = 64;           // keys per KV tile
constexpr int kPad = 8;           // bf16 of padding per shared-memory row

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the 16 bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, `lo` in the low half (round to nearest even)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Copy rows [row0, row0 + 64) of a (rows, D) bf16 matrix whose rows lie
// `stride` elements apart into a padded shared tile; rows >= nrows are
// zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* sh, const bf16* g, int row0,
                                          int nrows, size_t stride,
                                          int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kPerThread = kBK * kChunks / (kWarps * 32);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int idx = tid + i * kWarps * 32;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool ok = row0 + r < nrows;
    const bf16* src = ok ? g + static_cast<size_t>(row0 + r) * stride + c : g;
    cp_async16(sh + r * (D + kPad) + c, src, ok);
  }
}

// Fragment layouts of mma m16n8k16 (g = lane / 4, c = lane % 4): the A
// fragment holds rows g and g + 8 at columns 2c, 2c + 1 (a0, a1) and
// 2c + 8, 2c + 9 (a2, a3); B holds column g at rows 2c, 2c + 1 (b0) and
// 2c + 8, 2c + 9 (b1); the float32 result holds row g at columns 2c,
// 2c + 1 (c0, c1) and row g + 8 at the same columns (c2, c3).
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                int Tk, int H, int K, int q_off, int causal,
                float scale_log2) {
  static_assert(kBQ == kBK, "query and KV tiles share load_tile");
  constexpr int kLd = D + kPad;
  constexpr int kDT = D / 8;  // 8-wide output column tiles per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_sh = reinterpret_cast<bf16*>(smem_raw);  // kBQ x kLd
  bf16* k_sh = q_sh + kBQ * kLd;                   // 2 x kBK x kLd
  bf16* v_sh = k_sh + 2 * kBK * kLd;               // 2 x kBK x kLd

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int q0 = qt * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(K) * D;
  const bf16* qg = q + (static_cast<size_t>(b) * S * H + h) * D;
  const bf16* kg = k + (static_cast<size_t>(b) * Tk * K + kh) * D;
  const bf16* vg = v + (static_cast<size_t>(b) * Tk * K + kh) * D;

  // keys beyond are above the diagonal of the block's last row
  const int k_end = causal ? min(q_off + min(q0 + kBQ, S), Tk) : Tk;
  const int ntiles = (k_end + kBK - 1) / kBK;

  load_tile<D>(q_sh, qg, q0, S, q_stride, tid);
  if (ntiles > 0) {
    load_tile<D>(k_sh, kg, 0, Tk, kv_stride, tid);
    load_tile<D>(v_sh, vg, 0, Tk, kv_stride, tid);
  }
  cp_async_commit();

  // this thread's query rows, and their state: index 0 is row g of the
  // warp's 16, index 1 row g + 8 (`pos` their absolute positions); l is
  // this thread's partial sum over the columns it holds, summed across the
  // four threads of a row at the end
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int pos[2] = {q_off + row[0], q_off + row[1]};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  unsigned qf[D / 16][4];

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {
      load_tile<D>(k_sh + (buf ^ 1) * kBK * kLd, kg, (j + 1) * kBK, Tk,
                   kv_stride, tid);
      load_tile<D>(v_sh + (buf ^ 1) * kBK * kLd, vg, (j + 1) * kBK, Tk,
                   kv_stride, tid);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_all_but_newest();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], q_sh + (warp * 16 + (lane & 15)) * kLd +
                                kk * 16 + (lane >> 4) * 8);
    }
    const bf16* ks = k_sh + buf * kBK * kLd;
    const bf16* vs = v_sh + buf * kBK * kLd;

    // S = Q K^T over the tile: 8 column tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; nt += 2) {
        unsigned kf[4];
        ldmatrix_x4(kf, ks + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[nt], qf[kk], kf[0], kf[1]);
        mma_bf16(s[nt + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, mask, online softmax (base 2)
    const int k0 = j * kBK;
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = k0 + nt * 8 + c2 + (e & 1), r = e >> 1;
        const float x = ((!causal || t <= pos[r]) && t < Tk)
                            ? s[nt][e] * scale_log2
                            : kNegInf;
        s[nt][e] = x;
        tmax[r] = fmaxf(tmax[r], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      corr[r] = m_new == m[r] ? 1.f : exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = s[nt][e];
        const float p = x <= kNegInf / 2 ? 0.f : exp2f(x - m[r]);
        s[nt][e] = p;
        psum[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }

    // O += P V: P (bf16) is the A operand straight from the score
    // registers, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * kLd +
                                  dt * 8 + (lane >> 4) * 8);
        mma_bf16(o[dt], pa, vf[0], vf[1]);
        mma_bf16(o[dt + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the tile is consumed before its buffer is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    bf16* orow = out + (static_cast<size_t>(b) * S + row[r]) * q_stride +
                 static_cast<size_t>(h) * D + c2;
#pragma unroll
    for (int i = 0; i < kDT; ++i)
      *reinterpret_cast<unsigned*>(orow + i * 8) =
          pack_bf16(o[i][2 * r] / l[r], o[i][2 * r + 1] / l[r]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int K, int q_off, int causal,
                   float scale_log2, cudaStream_t stream) {
  const int smem = (kBQ + 4 * kBK) * (D + kPad) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_tc_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, Tk, H, K,
      q_off, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q: (B, S, H, d); k, v: (B, T, K, d); out: (B, S, H, d); all contiguous,
// dtype 0 = float32, 1 = bfloat16; d <= 128; with causal = 1 query row s
// attends keys t <= q_offset + s (q_offset >= 0), with causal = 0 all T
// keys (q_offset 0). tensor_cores = 0 runs the
// CUDA-core kernel with scale = 1/sqrt(d); 1 runs the tensor-core kernel
// (bfloat16, d 64 or 128, every pointer 16-byte aligned) with
// scale = log2(e)/sqrt(d).
TRAPTI_EXPORT int flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T, int H, int K, int d,
                                      int q_offset, int causal, float scale,
                                      int dtype,
                                      int tensor_cores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tensor_cores) {
    if (dtype == kBF16 && d == 64)
      err = tc::launch<64>(q, k, v, out, B, S, T, H, K, q_offset, causal,
                           scale, s);
    else if (dtype == kBF16 && d == 128)
      err = tc::launch<128>(q, k, v, out, B, S, T, H, K, q_offset, causal,
                            scale, s);
  } else if (dtype == kF32) {
    err = launch<float>(q, k, v, out, B, S, T, H, K, d, q_offset, causal,
                        scale, s);
  } else if (dtype == kBF16) {
    err = launch<__nv_bfloat16>(q, k, v, out, B, S, T, H, K, d, q_offset,
                                causal, scale, s);
  }
  return static_cast<int>(err);
}

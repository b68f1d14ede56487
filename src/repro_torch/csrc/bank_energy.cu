// Stage-II bank-energy kernels (TRAPTI Eq. 1/4/5) for Hopper.
//
// Replaces repro/kernels/bank_energy/kernel.py:
//   exact_bank_stats_kernel (_exact_kernel) -> exact_bank_stats_f64 below
//   bank_energy_kernel      (_bank_kernel)  -> bank_energy_f64 below
//
// Bound on the H100: the inputs are two f64 arrays of S segments read once
// (16 bytes per segment), so by bytes the work is tens of microseconds at
// most. What bounds these kernels is order: the exact statistics must agree
// with the float64 numpy reference to the last bits, so the time axis is a
// sequential f64 running sum, as np.cumsum computes it (a parallel scan
// rounds differently, and a run duration is a difference of two running
// times). The design keeps that one sequential dependency chain and
// nothing else serial:
//   * seq_cumsum_f64: one warp stages tiles of the durations through shared
//     memory with coalesced loads; lane 0 adds them in order. It runs once
//     per call and its result is shared by every candidate.
//   * exact_bank_stats_kernel: one block per candidate. The TPU grid carried
//     three values across segment tiles in order; CUDA blocks run in no
//     order, so the block itself walks the segments tile by tile. All its
//     threads compute the tile's bank activity ceil(occ/usable) (f64) and the
//     active bank-seconds; then one lane per bank walks the tile, carrying
//     the bank's last-exceed time and previous on/off state in registers,
//     and classifies each idle run against the break-even threshold
//     (>=, as the reference). The pre-trace state counts as ON, and the
//     run still open at trace end is flushed.
//   * bank_energy_kernel: one block per candidate, a grid-stride pass that
//     sums act * dur and |act_k - act_{k-1}|; a block reduction replaces the
//     TPU's carried previous activity.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;
constexpr int kScanTile = 1024;

__global__ void seq_cumsum_f64(const double* __restrict__ dur,
                               double* __restrict__ cum, long long S) {
  __shared__ double buf[kScanTile];
  const int lane = threadIdx.x;
  double t = 0.0;
  if (lane == 0) cum[0] = 0.0;
  for (long long k0 = 0; k0 < S; k0 += kScanTile) {
    const int n = static_cast<int>(min(static_cast<long long>(kScanTile), S - k0));
    for (int i = lane; i < n; i += 32) buf[i] = dur[k0 + i];
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        t += buf[i];
        buf[i] = t;
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) cum[k0 + i + 1] = buf[i];
    __syncwarp();
  }
}

// Sum of `v` over the block; the result is valid in thread 0.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
exact_bank_stats_kernel(const double* __restrict__ occ,
                        const double* __restrict__ dur,
                        const double* __restrict__ cum,
                        const double* __restrict__ usable,
                        const double* __restrict__ nbanks,
                        const double* __restrict__ threshold,
                        double* __restrict__ out, long long S) {
  __shared__ double cum_sh[kTile + 1];
  __shared__ unsigned short act_sh[kTile];
  __shared__ double red_f[kThreads / 32];
  __shared__ long long red_i[kThreads / 32];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const double u = usable[c];
  const double nbf = nbanks[c];
  const double th = threshold[c];
  const int bank = tid;  // the walking lane of bank `tid`
  const bool walker = bank < static_cast<int>(nbf);

  double act_s = 0.0;
  bool prev = true;      // pre-trace state counts as ON
  double last = 0.0;     // end time of the bank's last required segment
  long long n_long = 0, n_short = 0;
  double long_s = 0.0, short_s = 0.0;

  for (long long k0 = 0; k0 < S; k0 += kTile) {
    const int n = static_cast<int>(min(static_cast<long long>(kTile), S - k0));
    for (int i = tid; i < n; i += kThreads) {
      const double a = fmin(ceil(occ[k0 + i] / u), nbf);
      act_s += a * dur[k0 + i];
      act_sh[i] = static_cast<unsigned short>(fmax(a, 0.0));
      cum_sh[i + 1] = cum[k0 + i + 1];
    }
    if (tid == 0) cum_sh[0] = cum[k0];
    __syncthreads();
    if (walker) {
      for (int i = 0; i < n; ++i) {
        const bool exc = act_sh[i] > bank;
        if (exc) {
          if (!prev) {
            const double run = cum_sh[i] - last;
            if (run >= th) { ++n_long; long_s += run; }
            else { ++n_short; short_s += run; }
          }
          last = cum_sh[i + 1];
        }
        prev = exc;
      }
    }
    __syncthreads();
  }
  if (walker && !prev) {  // flush the run still open at trace end
    const double run = cum[S] - last;
    if (run >= th) { ++n_long; long_s += run; }
    else { ++n_short; short_s += run; }
  }

  const double t_act = block_sum(act_s, red_f);
  const long long t_nl = block_sum(n_long, red_i);
  const double t_ls = block_sum(long_s, red_f);
  const long long t_ns = block_sum(n_short, red_i);
  const double t_ss = block_sum(short_s, red_f);
  if (tid == 0) {
    double* o = out + 5LL * c;
    o[0] = t_act;
    o[1] = static_cast<double>(t_nl);
    o[2] = t_ls;
    o[3] = static_cast<double>(t_ns);
    o[4] = t_ss;
  }
}

__global__ void __launch_bounds__(kThreads)
bank_energy_kernel(const double* __restrict__ occ,
                   const double* __restrict__ dur,
                   const double* __restrict__ usable,
                   const double* __restrict__ nbanks,
                   double* __restrict__ out, long long S) {
  __shared__ double red_f[kThreads / 32];
  __shared__ long long red_i[kThreads / 32];
  const int c = blockIdx.x;
  const double u = usable[c];
  const double nbf = nbanks[c];
  double seconds = 0.0;
  long long toggles = 0;
  for (long long k = threadIdx.x; k < S; k += kThreads) {
    const double a = fmin(ceil(occ[k] / u), nbf);
    seconds += a * dur[k];
    if (k > 0) {
      const double ap = fmin(ceil(occ[k - 1] / u), nbf);
      toggles += static_cast<long long>(fabs(a - ap));
    }
  }
  const double t_s = block_sum(seconds, red_f);
  const long long t_t = block_sum(toggles, red_i);
  if (threadIdx.x == 0) {
    out[2LL * c] = t_s;
    out[2LL * c + 1] = static_cast<double>(t_t);
  }
}

}  // namespace

// occ, dur: (S,) f64; usable, nbanks, threshold: (C,) f64 with integral
// nbanks in [1, 256]; cum: (S + 1,) f64 scratch; out: (C, 5) f64.
TRAPTI_EXPORT int exact_bank_stats_f64(const void* occ, const void* dur,
                                       const void* usable, const void* nbanks,
                                       const void* threshold, void* cum,
                                       void* out, long long S, int C,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  seq_cumsum_f64<<<1, 32, 0, s>>>(static_cast<const double*>(dur),
                                  static_cast<double*>(cum), S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  exact_bank_stats_kernel<<<C, kThreads, 0, s>>>(
      static_cast<const double*>(occ), static_cast<const double*>(dur),
      static_cast<const double*>(cum), static_cast<const double*>(usable),
      static_cast<const double*>(nbanks),
      static_cast<const double*>(threshold), static_cast<double*>(out), S);
  return static_cast<int>(cudaGetLastError());
}

// occ, dur: (S,) f64; usable, nbanks: (C,) f64; out: (C, 2) f64.
TRAPTI_EXPORT int bank_energy_f64(const void* occ, const void* dur,
                                  const void* usable, const void* nbanks,
                                  void* out, long long S, int C,
                                  void* stream) {
  bank_energy_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(occ), static_cast<const double*>(dur),
      static_cast<const double*>(usable), static_cast<const double*>(nbanks),
      static_cast<double*>(out), S);
  return static_cast<int>(cudaGetLastError());
}

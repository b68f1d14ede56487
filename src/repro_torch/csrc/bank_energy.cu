// Stage-II bank-energy kernels (TRAPTI Eq. 1/4/5) for Hopper.
//
// Replaces repro/kernels/bank_energy/kernel.py:
//   exact_bank_stats_kernel (_exact_kernel) -> running_time_f64 (the scan)
//                                              + exact_bank_stats_f64 below
//   bank_energy_kernel      (_bank_kernel)  -> bank_energy_f64 below
//
// Bound on the H100: a trace of S segments is 16 bytes per segment (24 with
// the running time) and each (candidate, segment) needs one bank activity,
// so a sweep of C candidates is bound by C * S f64 operations (a few f64
// and integer operations per activity on the fast path of `Activity`).
// What the exact statistics add is order: they must agree with the float64
// numpy reference to the last bits, so the time axis is one sequential f64
// running sum, as np.cumsum computes it (a parallel scan rounds
// differently, and an idle run is a difference of two running times that
// is classified with >=). Its least time is S dependent f64 additions,
// which serial_floor_f64 times. Everything else is free of rounding order,
// and runs segment-parallel:
//
//   * running_time_kernel: one warp. 16-byte cp.async copies keep two
//     512-element tiles of durations in flight ahead of the adding chain.
//     Every lane runs the chain over the whole tile, reading pairs from
//     shared memory (a broadcast, loaded a batch ahead of use), the sum in
//     a register, and writes nothing: lane l only keeps the sum before its
//     run of 16 elements. While the next tile's chain runs, each lane
//     replays its run from that sum (the same additions in the same order,
//     so the same bits) and stores the 16 results, so no store sits on the
//     chain. Bit for bit np.r_[0, np.cumsum(d)].
//   * exact_walk_kernel: a grid over (chunk of the trace) x (group of
//     candidates), launched after the scan in stream order; a warp walks
//     one chunk for one candidate. The warps that share a chunk stage it
//     (occupancy, durations, running time) in shared memory once per 512
//     segments, double-buffered, for the whole group. Each lane computes
//     the activity min(ceil(occ/u), nb) of every 32nd segment of the piece
//     (bit for bit the IEEE f64 division's, mostly without one:
//     `Activity`), independently, into shared memory; then ballots over it
//     in order find where the activity changes, and each change is one
//     event: banks [a, p) fall, or banks [p, a) rise. Under contiguous
//     packing that is all a bank ever does, so the walk costs one activity
//     per (candidate, segment) plus one lane step per bank that changes
//     state. Per bank the warp keeps, in shared memory, the position and
//     time of its last fall in the chunk: a rise after one is a run inside
//     the chunk, classified at once; a rise before any (the bank was idle
//     when the chunk began) is left open. The chunk's summary per
//     (candidate, bank) is the position of its last fall (the end of its
//     last required segment) and of its open rise. The state before the
//     trace counts as all banks ON (a virtual activity nb before segment 0)
//     and the trace end as a rise of every idle bank at S.
//   * exact_resolve_kernel: one block per candidate. A warp per bank takes
//     a prefix max of the last-fall positions over the chunks (32 chunks a
//     step, carried across steps): chunk q's carry-in is the bank's last
//     fall before it, which closes q's open rise. It then sums, in a fixed
//     order, the chunks' partial sums and the banks' resolved runs. No
//     floating-point atomics: two calls give the same bits.
//   * bank_energy_kernel: a grid over (tile of the trace) x (group of
//     candidates); the block stages its tile and the segment before it in
//     shared memory once, and each warp walks the whole tile for every
//     eighth candidate of the group (a group of fewer than 8 candidates
//     splits the tile into slices, so every warp works). A lane walks a run
//     of consecutive segments, its previous activity in a register: one
//     activity per (candidate, segment) plus one per run. Per-tile partials
//     are reduced in tile order by energy_reduce_kernel.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kScanTile = 512;    // durations per scan tile
constexpr int kScanStages = 4;    // scan tiles in shared memory
constexpr int kStage = 512;       // segments a walk block stages per step

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte copy of which the first `bytes` come from `src`, the rest zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
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

// the bytes of the 16-byte piece at element k of an array of n doubles
__device__ __forceinline__ int piece_bytes(long long k, long long n) {
  const long long left = n - k;
  return left >= 2 ? 16 : (left == 1 ? 8 : 0);
}

// ------------------------------------------------------------------ scan
constexpr int kScanPairs = kScanTile / 2;  // (before, after) pairs a tile
constexpr int kScanRun = kScanPairs / 32;  // pairs a lane replays: 8
constexpr int kScanBatch = 8;              // pairs loaded ahead of the chain

// Pair p of a tile sits at p ^ ((p / kScanRun) & 7) in shared memory: the
// chain's broadcast reads do not care, and a lane's run of 8 pairs then
// spreads over all eight 16-byte bank groups, so the replay's reads, one
// run per lane, are free of bank conflicts.
__host__ __device__ constexpr int scan_slot(int p) {
  return p ^ ((p / kScanRun) & 7);
}

__device__ __forceinline__ void scan_load(double* buf, const double* dur,
                                          long long S, long long tile,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < kScanPairs / 32; ++j) {
    const int p = j * 32 + lane;
    const long long k = tile * kScanTile + 2 * p;
    const int bytes = piece_bytes(k, S);
    cp_async16(buf + 2 * scan_slot(p), bytes ? dur + k : dur, bytes);
  }
}

// The chain over one tile: every lane adds all of it, in order, to t; lane
// l keeps the running time before its run (pair 8l) in `start`.
__device__ __forceinline__ void scan_chain(const double* buf, double& t,
                                           double& start, int lane) {
  const double2* src = reinterpret_cast<const double2*>(buf);
  double2 cur[kScanBatch], nxt[kScanBatch];
#pragma unroll
  for (int m = 0; m < kScanBatch; ++m) cur[m] = src[scan_slot(m)];
#pragma unroll
  for (int b = 0; b < kScanPairs / kScanBatch; ++b) {
    if (b + 1 < kScanPairs / kScanBatch) {
#pragma unroll
      for (int m = 0; m < kScanBatch; ++m)
        nxt[m] = src[scan_slot((b + 1) * kScanBatch + m)];
    }
#pragma unroll
    for (int m = 0; m < kScanBatch; ++m) {
      const int p = b * kScanBatch + m;
      if (p % kScanRun == 0)  // a select: p is known at compile time
        start = lane == p / kScanRun ? t : start;
      t = (t + cur[m].x) + cur[m].y;
    }
#pragma unroll
    for (int m = 0; m < kScanBatch; ++m) cur[m] = nxt[m];
  }
}

// Lane l replays its run of the tile at cum index `base` from `x`, the
// chain's running time before it: the same additions in the same order, so
// the same bits. A whole tile (kWhole) stores without checking S, so its
// code has no branch to keep it apart from the chain it overlaps.
template <bool kWhole>
__device__ __forceinline__ void scan_replay(const double* buf, double* cum,
                                            long long base, double x,
                                            long long S, int lane) {
  const double2* src = reinterpret_cast<const double2*>(buf);
#pragma unroll
  for (int j = 0; j < kScanRun; ++j) {
    const int p = lane * kScanRun + j;
    const double2 v = src[scan_slot(p)];
    const double x1 = x + v.x;
    const long long k = base + 2 * p;
    // cum[0] is +0.0 (the chain starts from -0.0)
    const double2 out = make_double2(k == 0 ? 0.0 : x, x1);
    if (kWhole || k + 1 <= S)
      *reinterpret_cast<double2*>(cum + k) = out;
    else if (k <= S)
      cum[k] = out.x;
    x = x1 + v.y;
  }
}

__global__ void __launch_bounds__(32)
running_time_kernel(const double* __restrict__ dur, double* __restrict__ cum,
                    long long S) {
  __shared__ __align__(16) double in_s[kScanStages][kScanTile];
  const int lane = threadIdx.x;
  const long long ntiles = (S + kScanTile - 1) / kScanTile;
  // tile i is in buffer i % 4; the loop holds tiles i - 1 (its replay) and
  // i (the chain) while i + 1 and i + 2 are in flight
  scan_load(in_s[0], dur, S, 0, lane);
  cp_async_commit();
  scan_load(in_s[1], dur, S, 1, lane);
  cp_async_commit();
  // -0.0 + x == x for every x, so the first sum is d[0] itself, as
  // np.cumsum's
  double t = -0.0, start = 0.0;
  for (long long i = 0; i < ntiles; ++i) {
    scan_load(in_s[(i + 2) % kScanStages], dur, S, i + 2, lane);
    cp_async_commit();
    cp_async_wait<2>();
    __syncwarp();
    if (i == 0) {
      scan_chain(in_s[0], t, start, lane);
    } else {  // tile i - 1 is whole: its replay interleaves with the chain
      const double prev = start;
      scan_replay<true>(in_s[(i - 1) % kScanStages], cum,
                        (i - 1) * kScanTile, prev, S, lane);
      scan_chain(in_s[i % kScanStages], t, start, lane);
    }
    __syncwarp();
  }
  scan_replay<false>(in_s[(ntiles - 1) % kScanStages], cum,
                     (ntiles - 1) * kScanTile, start, S, lane);
  // a trace of whole tiles ends on a tile edge: its total is the last sum
  if (lane == 0 && S % kScanTile == 0) cum[S] = t;
}

// S dependent f64 additions in one thread, the operands in registers: the
// least time of any running time that keeps np.cumsum's bits. A yardstick
// for the scan (chip_smoke.py and scripts/torch_kernel_ab.py time it beside
// running_time_kernel); no wrapper launches it.
__global__ void serial_floor_kernel(const double* __restrict__ x,
                                    double* __restrict__ out, long long S) {
  const double v0 = x[0], v1 = x[1], v2 = x[2], v3 = x[3];
  double t = 0.0;
  long long i = 0;
#pragma unroll 4
  for (; i + 8 <= S; i += 8) {
    t += v0; t += v1; t += v2; t += v3;
    t += v0; t += v1; t += v2; t += v3;
  }
  for (; i < S; ++i) t += v0;
  out[0] = t;
}

// ------------------------------------------------------------ exact walk
struct WalkArgs {
  const double* occ;
  const double* dur;
  const double* cum;
  const double* usable;
  const double* nbanks;
  const double* threshold;
  int* last_fall;   // (C, bmax, Q): position of the bank's last fall, or -1
  int* open_rise;   // (C, bmax, Q): position of its open rise, or -1
  double* part;     // (C, Q, 5): the chunk's own sums
  long long S;
  long long chunk;  // segments per chunk, a multiple of kStage / W
  int C, bmax, G, W, Q, n_groups;
};

// The bank activity min(ceil(occ / u), nb) as a double, bit for bit that of
// the IEEE f64 division, without a division, a ceil or a min per segment:
// the division is a software sequence of many instructions, and ceil and
// min issue at a fraction of the rate of f64 adds and multiplies.
//
// Fast path: q = fl(occ * r) with r = fl(1 / u) taken once per candidate.
// For u in [2^-1000, 2^1000] and fl(occ * r) normal, q lies within a
// relative 2^-52 + 2^-106 of occ / u and y = fl(occ / u) within 2^-53, so
// |q - y| < q * 2^-51.
//   * q > nb + 1 (>= 2^-20 relatively more, by its high word): y > nb, so
//     the activity is nb.
//   * 0 < q <= nb + 1: z = q + 1.5 * 2^52 rounds q to an integer t (the low
//     word of z), and g = q - t is exact (Sterbenz). If |g| >= M = 2^-40 >
//     4 q 2^-51, no integer lies within q * 2^-51 of q, so ceil(y) =
//     ceil(q) = t + 1 (t if g < 0).
//   * occ = +0: 0 / u = +0.
// Every other occupancy (-0, a negative or NaN one, q within M of an
// integer, a u out of range) takes the division itself; -0 / u is taken
// from -0 / u divided once per candidate, since CUDA's division has a slow
// path for a zero dividend.
struct Activity {
  double u, r, nbf, pos_zero, neg_zero;
  int nb, hi_nbp1;
  bool fast;  // u in range: the fast path applies
  __device__ Activity(double usable, double nbanks)
      : u(usable), r(1.0 / usable), nbf(nbanks), pos_zero(0.0 / usable),
        neg_zero(-0.0 / usable), nb(static_cast<int>(nbanks)),
        fast(usable >= 0x1p-1000 && usable <= 0x1p1000) {
    hi_nbp1 = __double2hiint(nbanks + 1.0);
  }
  // the activity, and in `banks` the banks it requires (none for a negative
  // activity)
  __device__ __forceinline__ double of(double occ, int& banks) const {
    constexpr double kRound = 0x1.8p52;
    const double q = occ * r;
    const double z = q + kRound;
    const int hg = __double2hiint(q - (z - kRound));  // high word of g
    const int hq = __double2hiint(q);
    // q > nb + 1 when its high word is the larger (q >= 0 orders as its
    // bits); a q just above nb + 1 with the same high word is < 2^51 and
    // takes the general case, whose min with nb gives the same answer
    const bool big = hq > hi_nbp1;
    const bool zero = __double_as_longlong(occ) == 0;
    // q > 0 and normal-sized (a smaller one has |g| < M anyway)
    const bool clear = hq > 0 && (hg & 0x7fffffff) >= 0x3D700000;
    int ai = big ? nb : min(__double2loint(z) + 1 + (hg >> 31), nb);
    ai = zero ? 0 : ai;
    double a = __hiloint2double(0x43380000, ai) - kRound;
    if (!(fast && (big || zero || clear))) {
      const double y =
          occ == 0.0 ? (signbit(occ) ? neg_zero : pos_zero) : occ / u;
      a = fmin(ceil(y), nbf);
      ai = static_cast<int>(fmax(a, 0.0));
    }
    banks = ai;
    return a;
  }
  __device__ __forceinline__ int banks(double occ) const {
    int b;
    of(occ, b);
    return b;
  }
};

struct RunSums {
  double long_s = 0.0, short_s = 0.0;
  long long n_long = 0, n_short = 0;
  __device__ __forceinline__ void add(double run, double th) {
    if (run >= th) {
      ++n_long;
      long_s += run;
    } else {
      ++n_short;
      short_s += run;
    }
  }
};

// One change of activity p -> a at position k (running time t), for the
// banks of this lane: bank b is always lane b mod 32's, so a lane reads
// only the state it wrote.
__device__ __forceinline__ void walk_event(int k, double t, int p, int a,
                                           int lane, double th, double* lft,
                                           int* lfp, int* orp, RunSums& r) {
  if (a < p) {
    for (int b = a + ((lane - a) & 31); b < p; b += 32) {
      lft[b] = t;
      lfp[b] = k;
    }
  } else {
    for (int b = p + ((lane - p) & 31); b < a; b += 32) {
      if (lfp[b] >= 0)
        r.add(t - lft[b], th);
      else
        orp[b] = k;
    }
  }
}

// at least four blocks per SM: registers are capped so that they fit
__global__ void __launch_bounds__(kWarps * 32, 4)
exact_walk_kernel(const WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* occ_s = reinterpret_cast<double*>(smem);   // [2][kStage]
  double* dur_s = occ_s + 2 * kStage;                // [2][kStage]
  double* cum_s = dur_s + 2 * kStage;                // [2][kStage]
  double* lft_s = cum_s + 2 * kStage;                // [kWarps][bmax]
  int* lfp_s = reinterpret_cast<int*>(lft_s + kWarps * a.bmax);
  int* orp_s = lfp_s + kWarps * a.bmax;
  // [kWarps][kStage]: the activities of the warp's piece
  unsigned short* act_b =
      reinterpret_cast<unsigned short*>(orp_s + kWarps * a.bmax);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp % a.G, j = warp / a.G;  // candidate and chunk slot
  const int gi = blockIdx.x % a.n_groups;
  const long long q =
      static_cast<long long>(blockIdx.x / a.n_groups) * a.W + j;
  if (q >= a.Q) return;  // the slot's G warps leave together
  const int piece = kStage / a.W;
  const int slot_threads = a.G * 32, slot_tid = g * 32 + lane;
  const long long k0 = q * a.chunk;
  const long long k1 = min(k0 + a.chunk, a.S);
  const int steps = static_cast<int>((k1 - k0 + piece - 1) / piece);
  const int c = gi * a.G + g;
  const bool busy = c < a.C;  // idle warps still stage and sync

  double th = 0.0;
  int nb = 0;
  const Activity act(busy ? a.usable[c] : 1.0, busy ? a.nbanks[c] : 0.0);
  if (busy) {
    th = a.threshold[c];
    nb = act.nb;
  }
  double* lft = lft_s + warp * a.bmax;
  int* lfp = lfp_s + warp * a.bmax;
  int* orp = orp_s + warp * a.bmax;
  unsigned short* acts = act_b + warp * kStage;
  for (int b = lane; b < nb; b += 32) {
    lfp[b] = -1;
    orp[b] = -1;
  }
  auto event = [&](int k, double t, int p, int e, RunSums& r) {
    walk_event(k, t, p, e, lane, th, lft, lfp, orp, r);
  };
  // activity before the chunk; before the trace every bank counts as ON
  int prev = nb;
  if (busy && k0 > 0) prev = act.banks(a.occ[k0 - 1]);
  double act_s = 0.0;
  RunSums r;

  auto stage = [&](int s) {
    const long long base = k0 + static_cast<long long>(s) * piece;
    const int off = (s & 1) * kStage + j * piece;
    for (int p = slot_tid; p < piece / 2; p += slot_threads) {
      const long long k = base + 2 * p;
      const int bytes = piece_bytes(k, k1);
      const long long src = bytes ? k : 0;
      cp_async16(occ_s + off + 2 * p, a.occ + src, bytes);
      cp_async16(dur_s + off + 2 * p, a.dur + src, bytes);
      cp_async16(cum_s + off + 2 * p, a.cum + src, bytes);
    }
    cp_async_commit();
  };

  stage(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    bar_sync(1 + j, slot_threads);
    if (busy) {
      const long long base = k0 + static_cast<long long>(s) * piece;
      const int n = static_cast<int>(min(static_cast<long long>(piece),
                                         k1 - base));
      const int off = (s & 1) * kStage + j * piece;
      // the piece's activities, independent of each other
#pragma unroll 4
      for (int i = lane; i < n; i += 32) {
        int ai;
        const double af = act.of(occ_s[off + i], ai);
        act_s += af * dur_s[off + i];
        acts[i] = static_cast<unsigned short>(ai);
      }
      __syncwarp();
      // where they change, in order: each change is one event
      for (int i = 0; i < n; i += 32) {
        const int e = i + lane;
        const int ai = e < n ? acts[e] : 0;
        const int pa = e == 0 ? prev : (e < n ? acts[e - 1] : 0);
        unsigned ev = __ballot_sync(kFull, e < n && ai != pa);
        while (ev) {
          const int src = __ffs(ev) - 1;
          ev &= ev - 1;
          const int at = i + src;
          event(static_cast<int>(base + at), cum_s[off + at],
                at == 0 ? prev : acts[at - 1], acts[at], r);
        }
      }
      prev = acts[n - 1];
      __syncwarp();  // acts is rewritten next step
    }
    bar_sync(1 + j, slot_threads);
  }
  if (!busy) return;
  if (k1 == a.S)  // the trace end: every idle bank rises at S
    event(static_cast<int>(a.S), a.cum[a.S], prev, nb, r);
  for (int b = lane; b < nb; b += 32) {
    const size_t at = (static_cast<size_t>(c) * a.bmax + b) * a.Q + q;
    a.last_fall[at] = lfp[b];
    a.open_rise[at] = orp[b];
  }
  act_s = warp_sum(act_s);
  const double long_s = warp_sum(r.long_s), short_s = warp_sum(r.short_s);
  const long long n_long = warp_sum(r.n_long), n_short = warp_sum(r.n_short);
  if (lane == 0) {
    double* p = a.part + (static_cast<size_t>(c) * a.Q + q) * 5;
    p[0] = act_s;
    p[1] = static_cast<double>(n_long);
    p[2] = long_s;
    p[3] = static_cast<double>(n_short);
    p[4] = short_s;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
exact_resolve_kernel(const double* __restrict__ cum,
                     const double* __restrict__ nbanks,
                     const double* __restrict__ threshold,
                     const int* __restrict__ last_fall,
                     const int* __restrict__ open_rise,
                     const double* __restrict__ part,
                     double* __restrict__ out, int bmax, int Q) {
  __shared__ double red_f[kWarps][2];
  __shared__ long long red_i[kWarps][2];
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = static_cast<int>(nbanks[c]);
  const double th = threshold[c];
  RunSums r;
  for (int b = warp; b < nb; b += kWarps) {
    const size_t row = (static_cast<size_t>(c) * bmax + b) * Q;
    int carry = -1;  // the bank's last fall before this step's chunks
    for (int q0 = 0; q0 < Q; q0 += 32) {
      const int q = q0 + lane;
      const int f = q < Q ? last_fall[row + q] : -1;
      const int o = q < Q ? open_rise[row + q] : -1;
      int inc = f;  // positions grow with q: the max is the last fall
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc = max(inc, y);
      }
      int before = __shfl_up_sync(kFull, inc, 1);
      before = max(lane == 0 ? -1 : before, carry);
      // a bank idle at a chunk's start fell before it (all start ON)
      if (o >= 0 && before >= 0) r.add(cum[o] - cum[before], th);
      carry = max(carry, __shfl_sync(kFull, inc, 31));
    }
  }
  const double long_s = warp_sum(r.long_s), short_s = warp_sum(r.short_s);
  const long long n_long = warp_sum(r.n_long), n_short = warp_sum(r.n_short);
  if (lane == 0) {
    red_f[warp][0] = long_s;
    red_f[warp][1] = short_s;
    red_i[warp][0] = n_long;
    red_i[warp][1] = n_short;
  }
  __syncthreads();
  if (warp != 0) return;
  double s[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int q = lane; q < Q; q += 32) {
    const double* p = part + (static_cast<size_t>(c) * Q + q) * 5;
#pragma unroll
    for (int i = 0; i < 5; ++i) s[i] += p[i];
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) s[i] = warp_sum(s[i]);
  if (lane == 0) {
    long long nl = static_cast<long long>(s[1]);
    long long ns = static_cast<long long>(s[3]);
    double ls = s[2], ss = s[4];
    for (int w = 0; w < kWarps; ++w) {
      ls += red_f[w][0];
      ss += red_f[w][1];
      nl += red_i[w][0];
      ns += red_i[w][1];
    }
    double* o = out + 5LL * c;
    o[0] = s[0];
    o[1] = static_cast<double>(nl);
    o[2] = ls;
    o[3] = static_cast<double>(ns);
    o[4] = ss;
  }
}

// ------------------------------------------------------------ lower bound
__global__ void __launch_bounds__(kWarps * 32)
bank_energy_kernel(const double* __restrict__ occ,
                   const double* __restrict__ dur,
                   const double* __restrict__ usable,
                   const double* __restrict__ nbanks,
                   double* __restrict__ part, long long S, int C, int tile,
                   int group, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  // a warp walks the whole tile for its candidates when the group fills
  // the block; a smaller group gives each candidate wpc warps, one slice of
  // the tile each. A lane walks `run` consecutive segments of its warp's
  // slice, so its previous activity is in a register.
  int wpc = 1;
  while (wpc * 2 * group <= kWarps) wpc *= 2;
  const int sub = tile / wpc, run = sub / 32;
  // segment t0 + e sits at e + e / run: one slot of padding per run keeps
  // the 32 lanes' runs in distinct banks
  const int padded = tile + tile / run;
  double* occ_s = reinterpret_cast<double*>(smem);
  double* dur_s = occ_s + padded;
  double* red_s = dur_s + padded;                   // [group][wpc][2]
  __shared__ double before;                         // occ[t0 - 1]
  const int ti = blockIdx.x, gy = blockIdx.y;
  const long long t0 = static_cast<long long>(ti) * tile;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const long long k = t0 + e;
    occ_s[e + e / run] = k < S ? occ[k] : 0.0;
    dur_s[e + e / run] = k < S ? dur[k] : 0.0;
  }
  if (threadIdx.x == 0) before = t0 > 0 ? occ[t0 - 1] : 0.0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = warp % wpc;
  const int e0 = slice * sub + lane * run;  // the lane's first segment
  const long long k0 = t0 + e0;
  const int n = static_cast<int>(
      max(0LL, min(static_cast<long long>(run), S - k0)));
  const double* o = occ_s + e0 + e0 / run;
  const double* dd = dur_s + e0 + e0 / run;
  // the occupancy before the run (the trace's first segment has no toggle:
  // it is its own "before")
  const double o_prev = k0 == 0 ? o[0]
                        : e0 == 0 ? before
                                  : occ_s[e0 - 1 + (e0 - 1) / run];
  for (int gl = warp / wpc; gl < group; gl += kWarps / wpc) {
    const int c = gy * group + gl;
    if (c >= C) break;
    double sec = 0.0, tog = 0.0;
    if (n > 0) {
      const Activity activity(usable[c], nbanks[c]);
      int banks;
      double prev = activity.of(o_prev, banks);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const double act = activity.of(o[j], banks);
        sec += act * dd[j];
        tog += fabs(act - prev);
        prev = act;
      }
    }
    sec = warp_sum(sec);
    tog = warp_sum(tog);
    if (lane == 0) {
      red_s[(gl * wpc + slice) * 2] = sec;
      red_s[(gl * wpc + slice) * 2 + 1] = tog;
    }
  }
  __syncthreads();
  for (int gl = threadIdx.x; gl < group; gl += blockDim.x) {
    const int c = gy * group + gl;
    if (c >= C) break;
    double sec = 0.0, tog = 0.0;
    for (int w = 0; w < wpc; ++w) {
      sec += red_s[(gl * wpc + w) * 2];
      tog += red_s[(gl * wpc + w) * 2 + 1];
    }
    part[(static_cast<size_t>(c) * n_tiles + ti) * 2] = sec;
    part[(static_cast<size_t>(c) * n_tiles + ti) * 2 + 1] = tog;
  }
}

// one warp per candidate: its tiles' partials in tile order
__global__ void __launch_bounds__(kWarps * 32)
energy_reduce_kernel(const double* __restrict__ part,
                     double* __restrict__ out, int C, int n_tiles) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;
  double sec = 0.0, tog = 0.0;
  for (int t = lane; t < n_tiles; t += 32) {
    sec += part[(static_cast<size_t>(c) * n_tiles + t) * 2];
    tog += part[(static_cast<size_t>(c) * n_tiles + t) * 2 + 1];
  }
  sec = warp_sum(sec);
  tog = warp_sum(tog);
  if (lane == 0) {
    out[2LL * c] = sec;
    out[2LL * c + 1] = tog;
  }
}

}  // namespace

// dur: (S,) f64, 16-byte aligned; cum: (S + 1,) f64, 16-byte aligned.
TRAPTI_EXPORT int running_time_f64(const void* dur, void* cum, long long S,
                                   void* stream) {
  running_time_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(dur), static_cast<double*>(cum), S);
  return static_cast<int>(cudaGetLastError());
}

// x: (4,) f64 addends; out: (1,) f64, their sum taken S times in turn.
TRAPTI_EXPORT int serial_floor_f64(const void* x, void* out, long long S,
                                   void* stream) {
  serial_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(out), S);
  return static_cast<int>(cudaGetLastError());
}

// occ, dur: (S,) f64 and cum: (S + 1,) f64, all 16-byte aligned;
// usable, nbanks, threshold: (C,) f64 with integral nbanks in [1, bmax];
// last_fall, open_rise: (C * bmax * Q,) int32 and part: (C * Q * 5,) f64
// scratch; out: (C, 5) f64. The plan (G candidates x W chunks of `chunk`
// segments per block, Q chunks) comes from the wrapper's `walk_plan`.
TRAPTI_EXPORT int exact_bank_stats_f64(
    const void* occ, const void* dur, const void* cum, const void* usable,
    const void* nbanks, const void* threshold, void* last_fall,
    void* open_rise, void* part, void* out, long long S, int C, int bmax,
    int G, int W, long long chunk, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WalkArgs a;
  a.occ = static_cast<const double*>(occ);
  a.dur = static_cast<const double*>(dur);
  a.cum = static_cast<const double*>(cum);
  a.usable = static_cast<const double*>(usable);
  a.nbanks = static_cast<const double*>(nbanks);
  a.threshold = static_cast<const double*>(threshold);
  a.last_fall = static_cast<int*>(last_fall);
  a.open_rise = static_cast<int*>(open_rise);
  a.part = static_cast<double*>(part);
  a.S = S;
  a.chunk = chunk;
  a.C = C;
  a.bmax = bmax;
  a.G = G;
  a.W = W;
  a.Q = Q;
  a.n_groups = (C + G - 1) / G;
  const int smem = 6 * kStage * sizeof(double) +
                   kWarps * bmax * (sizeof(double) + 2 * sizeof(int)) +
                   kWarps * kStage * sizeof(unsigned short);
  cudaError_t err = cudaFuncSetAttribute(
      exact_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int spans = (Q + W - 1) / W;
  exact_walk_kernel<<<a.n_groups * spans, kWarps * 32, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  exact_resolve_kernel<<<C, kWarps * 32, 0, s>>>(
      a.cum, a.nbanks, a.threshold, a.last_fall, a.open_rise, a.part,
      static_cast<double*>(out), bmax, Q);
  return static_cast<int>(cudaGetLastError());
}

// occ, dur: (S,) f64; usable, nbanks: (C,) f64; part: (C * n_tiles * 2,)
// f64 scratch with n_tiles = ceil(S / tile); out: (C, 2) f64. `tile` is a
// power of two from 256 to 2048 and `group` candidates share a block
// (`energy_plan`).
TRAPTI_EXPORT int bank_energy_f64(const void* occ, const void* dur,
                                  const void* usable, const void* nbanks,
                                  void* part, void* out, long long S, int C,
                                  int tile, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((S + tile - 1) / tile);
  // padded tile (one slot per lane run of at least tile / 256 segments)
  // twice, and the partials of up to max(group, kWarps) (candidate, slice)
  const int smem = (2 * (tile + 256) + 2 * max(group, kWarps)) *
                   static_cast<int>(sizeof(double));
  cudaError_t err = cudaFuncSetAttribute(
      bank_energy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, (C + group - 1) / group);
  bank_energy_kernel<<<grid, kWarps * 32, smem, s>>>(
      static_cast<const double*>(occ), static_cast<const double*>(dur),
      static_cast<const double*>(usable), static_cast<const double*>(nbanks),
      static_cast<double*>(part), S, C, tile, group, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  energy_reduce_kernel<<<(C + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
      static_cast<const double*>(part), static_cast<double*>(out), C,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Columnar placement step kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels _pool_kernel and _score_kernel of
// src/repro/kernels/placement.py (row math _pool_row_math and
// _score_row_math), together with the host rankings the reference runs
// after _pool_kernel (the second halves of pick_orders).
//
// Bound.  At the scheduler's shapes (B ~ 64 work rows of N ~ 300-500
// clocks, S ~ 20-32 servers; C ~ 64 probed candidates) both kernels move a
// few hundred KB and do a few hundred thousand float64 operations: their
// bounds are below the card's per-launch floor (~2 us).  What the caller
// waits on is the round trip: the host packs one step's inputs, copies
// them up, launches, copies the results back and waits.  So each kernel
// does ALL of its step's work in one launch (K3 also ranks the picks,
// which the reference left to host NumPy sorts), and reads and writes one
// packed buffer each way: pool_step / score_step below make the copy up,
// the launch, the copy back and the wait in one call from the wrapper.
//
// pool_kernel (K3), one block of 512 threads per work row b of the
// busy-time clocks U [B, N]:
//   * pass A, over the row in chunks of up to kChunk GPUs staged in shared
//     memory by coalesced loads: the Eq. (16) pool counts V = U + rho/u <=
//     theta + 1e-9 at the row's two extreme thetas (integers, reduced by
//     warp shuffles: exact in any order); then one thread per server adds
//     that server's clocks in GPU-id order with explicit __dadd_rn (carried
//     across chunks), the sequence np.bincount(gpu_server, weights=U)
//     uses, and counts its feasible slots;
//   * one warp picks the FA-FFP best server by an exact lexicographic
//     argmin over (feasible slots left, -load, server id);
//   * for an LBSGF row (pid 1): the server keys load / capacity, their
//     stable rank by counting, the capacity prefix m = min(#(cum <
//     lambda*G) + 1, S) by a warp scan in rank order, and each server's
//     rank, or -1 beyond the prefix;
//   * pass B: each GPU's sort key -- FA-FFP (0, best-server-or-pool ? U :
//     inf), LBSGF (pool ? server rank : S + 1, pool ? U : inf) -- and its
//     rank; order[b, rank_i] = i.  A GPU outside the pool holds the row's
//     largest key, so those rank last in id order (a block scan of their
//     flags).  A pool GPU's rank is counted: the number of GPUs j whose
//     key is smaller, or equal with j < i, over the keys staged chunk by
//     chunk (once when the row fits one chunk).  Keys are compared with <
//     and == on doubles, never by bit pattern, so this is np.argsort(kind=
//     "stable") and np.lexsort exactly, inf ties and +-0.0 included (the
//     clocks are never NaN).  A pool of P GPUs costs P N compares: P is
//     the best server's feasible slots for a fitting FA-FFP row, but up to
//     N when FA-FFP spreads or LBSGF's prefix spans every server.
//   Outputs go into one packed int64 buffer (layout at pool_stats below).
//
// score_kernel (K4), one warp per probed candidate row of Y [C, S], lanes
//   striding over the servers: the occupied-server count n_srv (warp
//   integer sum) and, on a heterogeneous cluster, the three masked minima
//   (warp fmin: order-free for non-NaN values); then lane 0 prices Eq. (7)
//   k = max(xi1 * p, 1), f = k + alpha * (k - 1), gamma = xi2 * n_srv and
//   Eq. (8) tau in NumPy's order with every rounding explicit, phi =
//   max(1, floor(1/tau)) and the rho-hat slot count ceil(iters/phi).  The
//   reference priced k, f and gamma on the host only because XLA contracts
//   a*b + c into an FMA; here __d*_rn and -fmad=false keep them apart.
//   Output: tau [C] then rho [C], float64, in one buffer.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPoolThreads = 512;
constexpr int kPoolWarps = kPoolThreads / 32;
// GPUs of a row one shared-memory pass holds (16 bytes each).
constexpr int kChunk = 2048;
constexpr int kSmemDefault = 48 * 1024;
// Dynamic shared memory a launch may ask for (the H100's per-block limit).
constexpr int kMaxSmem = 227 * 1024;
constexpr int kScoreWarps = 4;

// A GPU's sort key in shared memory: (r, u) compared lexicographically.
struct __align__(16) Key {
  double u;
  int r;
};

struct Best {
  long long slots_left;  // feasible slots left after placing, N + 1 if none
  double neg_load;       // -(busy time on the server), +inf if no fit
  int id;                // server id
};

__device__ __forceinline__ bool before(const Best& a, const Best& b) {
  if (a.slots_left != b.slots_left) return a.slots_left < b.slots_left;
  if (a.neg_load != b.neg_load) return a.neg_load < b.neg_load;
  return a.id < b.id;
}

// GPU i's sort key (kr, ku) and whether it is in the LBSGF pool.
__device__ __forceinline__ bool gpu_key(int i, const double* __restrict__ u,
                                        const int64_t* __restrict__ gpu_server,
                                        double ru, double lo, bool lbsgf,
                                        int best, bool fit,
                                        const int* s_srank, int S, int& kr,
                                        double& ku) {
  const double x = u[i];
  const bool feas = __dadd_rn(x, ru) <= lo;
  const int srv = static_cast<int>(gpu_server[i]);
  if (lbsgf) {
    const int r = s_srank[srv];
    const bool pool = feas && r >= 0;
    kr = pool ? r : S + 1;
    ku = pool ? x : INFINITY;
    return pool;
  }
  kr = 0;
  ku = (fit ? feas && srv == best : feas) ? x : INFINITY;
  return false;
}

// Packed output of pool_kernel, int64 words (load as float64 bits, the
// flags ok and has_fit as B bool bytes at the start of B words):
//   [0, B) c_lo | [B, 2B) c_hi | [2B, 3B) ok | [3B, 3B + BN) order |
//   then best_srv [B] | has_fit [B] | load [B, S] | cnt [B, S].
// The first 3B + BN words are all pick_orders copies back.  One block an
// SM: with the block size alone as its bound, ptxas keeps 40 registers
// and spills.
__global__ void __launch_bounds__(kPoolThreads, 1)
    pool_kernel(const double* __restrict__ U, const double* __restrict__ th_lo,
                const double* __restrict__ th_hi,
                const double* __restrict__ rho_u,
                const int64_t* __restrict__ pid, long long G, double lam_G,
                const int64_t* __restrict__ offsets,
                const int64_t* __restrict__ caps,
                const int64_t* __restrict__ gpu_server, int B, int N, int S,
                int chunk, int64_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* s_key = reinterpret_cast<Key*>(smem);               // [chunk], pass B
  double* s_u = reinterpret_cast<double*>(smem);           // [chunk], pass A
  double* s_load = reinterpret_cast<double*>(s_key + chunk);    // [S]
  double* s_skey = s_load + S;                                  // [S]
  long long* s_cnt = reinterpret_cast<long long*>(s_skey + S);  // [S]
  long long* s_off = s_cnt + S;                                 // [S]
  long long* s_cap = s_off + S;                                 // [S]
  int* s_srank = reinterpret_cast<int*>(s_cap + S);             // [S]
  int* s_sorder = s_srank + S;                                  // [S]
  __shared__ int s_ws[4 * kPoolWarps];
  __shared__ int s_scan[kPoolWarps];
  __shared__ int s_best, s_fit, s_m;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const double* u = U + static_cast<long long>(b) * N;
  const double ru = rho_u[b];
  const double lo = __dadd_rn(th_lo[b], 1e-9);
  const double hi = __dadd_rn(th_hi[b], 1e-9);
  const bool lbsgf = pid[b] == 1;
  const long long BN = static_cast<long long>(B) * N;
  const long long BS = static_cast<long long>(B) * S;

  for (int s = tid; s < S; s += kPoolThreads) {
    s_load[s] = 0.0;
    s_cnt[s] = 0;
    s_off[s] = offsets[s];
    s_cap[s] = caps[s];
  }

  // Pass A: pool counts and per-server sums, chunk by chunk.
  int my_lo = 0, my_hi = 0;
  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int len = min(chunk, N - c0);
    __syncthreads();  // server arrays staged / the last chunk's sums done
    for (int k = tid; k < len; k += kPoolThreads) {
      const double x = u[c0 + k];
      s_u[k] = x;
      const double v = __dadd_rn(x, ru);
      my_lo += v <= lo;
      my_hi += v <= hi;
    }
    __syncthreads();
    for (int s = tid; s < S; s += kPoolThreads) {
      const long long first = max(s_off[s], static_cast<long long>(c0));
      const long long last = min(s_off[s] + s_cap[s],
                                 static_cast<long long>(c0) + len);
      if (first >= last) continue;
      double acc = s_load[s];
      long long k = s_cnt[s];
      for (long long i = first; i < last; ++i) {  // GPU-id order
        const double x = s_u[i - c0];
        acc = __dadd_rn(acc, x);
        k += __dadd_rn(x, ru) <= lo;
      }
      s_load[s] = acc;
      s_cnt[s] = k;
    }
  }
  my_lo = __reduce_add_sync(kFull, my_lo);
  my_hi = __reduce_add_sync(kFull, my_hi);
  if (lane == 0) {
    s_ws[warp] = my_lo;
    s_ws[kPoolWarps + warp] = my_hi;
  }
  __syncthreads();

  for (int s = tid; s < S; s += kPoolThreads) {
    out[5 * B + BN + static_cast<long long>(b) * S + s] =
        __double_as_longlong(s_load[s]);
    out[5 * B + BN + BS + static_cast<long long>(b) * S + s] = s_cnt[s];
  }
  if (warp == 0) {
    Best best = {LLONG_MAX, INFINITY, INT_MAX};
    for (int s = lane; s < S; s += 32) {
      const bool fits = s_cnt[s] >= G;
      const Best mine = {fits ? s_cnt[s] - G : static_cast<long long>(N) + 1,
                         fits ? -s_load[s] : INFINITY, s};
      if (before(mine, best)) best = mine;
    }
    for (int off = 16; off > 0; off >>= 1) {
      Best other;
      other.slots_left = __shfl_xor_sync(kFull, best.slots_left, off);
      other.neg_load = __shfl_xor_sync(kFull, best.neg_load, off);
      other.id = __shfl_xor_sync(kFull, best.id, off);
      if (before(other, best)) best = other;
    }
    if (lane == 0) {
      s_best = best.id;
      s_fit = best.slots_left <= N;
    }
  }
  if (lbsgf) {
    for (int s = tid; s < S; s += kPoolThreads)
      s_skey[s] = __ddiv_rn(s_load[s], static_cast<double>(s_cap[s]));
  }
  __syncthreads();

  if (lbsgf) {
    // Stable rank of the servers by load / capacity.
    for (int s = tid; s < S; s += kPoolThreads) {
      const double key = s_skey[s];
      int r = 0;
      for (int t = 0; t < S; ++t) {
        const double kt = s_skey[t];
        r += (kt < key) | ((kt == key) & (t < s));
      }
      s_srank[s] = r;
      s_sorder[r] = s;
    }
    __syncthreads();
    if (warp == 0) {
      // Capacity prefix sums in rank order (integers, exact): m counts
      // the ranks whose prefix stays below lambda * G, plus one.
      long long carry = 0;
      int below = 0;
      for (int r0 = 0; r0 < S; r0 += 32) {
        const int r = r0 + lane;
        long long c = r < S ? s_cap[s_sorder[r]] : 0;
        for (int off = 1; off < 32; off <<= 1) {
          const long long y = __shfl_up_sync(kFull, c, off);
          if (lane >= off) c += y;
        }
        const long long cum = carry + c;
        below += __popc(__ballot_sync(
            kFull, r < S && static_cast<double>(cum) < lam_G));
        carry = __shfl_sync(kFull, cum, 31);
      }
      if (lane == 0) s_m = min(below + 1, S);
    }
    __syncthreads();
    for (int s = tid; s < S; s += kPoolThreads)
      if (s_srank[s] >= s_m) s_srank[s] = -1;
    __syncthreads();
  }

  int c_lo = 0, c_hi = 0;
  for (int w = 0; w < kPoolWarps; ++w) {
    c_lo += s_ws[w];
    c_hi += s_ws[kPoolWarps + w];
  }
  const int best = s_best;
  const bool fit = s_fit;

  // Pass B.  Every GPU outside the pool (FA-FFP: key inf; LBSGF: (S + 1,
  // inf)) holds the row's largest key, so those GPUs rank after all
  // others in id order: n_small plus the number of them before i, a block
  // scan.  Only the others count smaller keys.  A row of one chunk keeps
  // its keys in shared memory from here on; a wider row restages them.
  const int kr_big = lbsgf ? S + 1 : 0;
  const bool one_chunk = N <= chunk;
  int my_small = 0, my_pool = 0;
  for (int i = tid; i < N; i += kPoolThreads) {
    int kr;
    double ku;
    my_pool += gpu_key(i, u, gpu_server, ru, lo, lbsgf, best, fit, s_srank,
                       S, kr, ku);
    my_small += !(kr == kr_big && ku == INFINITY);
    if (one_chunk) {  // pass A's U there is read and done
      s_key[i].r = kr;
      s_key[i].u = ku;
    }
  }
  my_pool = __reduce_add_sync(kFull, my_pool);
  my_small = __reduce_add_sync(kFull, my_small);
  if (lane == 0) {
    s_ws[2 * kPoolWarps + warp] = my_pool;
    s_ws[3 * kPoolWarps + warp] = my_small;
  }
  __syncthreads();
  int pool = 0, n_small = 0;
  for (int w = 0; w < kPoolWarps; ++w) {
    pool += s_ws[2 * kPoolWarps + w];
    n_small += s_ws[3 * kPoolWarps + w];
  }

  int64_t* order = out + 3 * B + static_cast<long long>(b) * N;
  int carry = 0;  // outside-pool GPUs before this group of GPUs
  for (int i0 = 0; i0 < N; i0 += kPoolThreads) {
    const int i = i0 + tid;
    const bool active = i < N;
    int kr = kr_big;
    double ku = INFINITY;
    if (active && one_chunk) {
      kr = s_key[i].r;
      ku = s_key[i].u;
    } else if (active) {
      gpu_key(i, u, gpu_server, ru, lo, lbsgf, best, fit, s_srank, S, kr,
              ku);
    }
    const bool big = active && kr == kr_big && ku == INFINITY;
    const unsigned ballot = __ballot_sync(kFull, big);
    if (lane == 0) s_scan[warp] = __popc(ballot);
    int rank = 0;
    for (int c0 = 0; c0 < N; c0 += chunk) {
      const int len = min(chunk, N - c0);
      if (!one_chunk) {
        __syncthreads();  // the last chunk's keys are done
        for (int k = tid; k < len; k += kPoolThreads)
          gpu_key(c0 + k, u, gpu_server, ru, lo, lbsgf, best, fit, s_srank,
                  S, s_key[k].r, s_key[k].u);
        __syncthreads();
      }
      if (active && !big) {
#pragma unroll 8
        for (int j = 0; j < len; ++j) {
          const Key kj = s_key[j];  // one 16-byte broadcast load
          rank += (kj.r < kr) |
                  ((kj.r == kr) &
                   ((kj.u < ku) | ((kj.u == ku) & (c0 + j < i))));
        }
      }
    }
    __syncthreads();  // s_scan of this group complete
    int before = carry + __popc(ballot & ((1u << lane) - 1u)), group = 0;
    for (int w = 0; w < kPoolWarps; ++w) {
      const int n = s_scan[w];
      before += w < warp ? n : 0;
      group += n;
    }
    if (active) order[big ? n_small + before : rank] = i;
    carry += group;
    __syncthreads();  // s_scan read before the next group writes it
  }
  if (tid == 0) {
    out[b] = c_lo;
    out[B + b] = c_hi;
    reinterpret_cast<bool*>(out + 2 * B)[b] = lbsgf ? pool >= G : c_lo >= G;
    out[3 * B + BN + b] = best;
    reinterpret_cast<bool*>(out + 4 * B + BN)[b] = fit;
  }
}

__device__ __forceinline__ double warp_min(double x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmin(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__global__ void __launch_bounds__(kScoreWarps * 32)
    score_kernel(const int64_t* __restrict__ Y, const double* __restrict__ p,
                 const double* __restrict__ speed_floor,
                 const double* __restrict__ uplink_sh,
                 const double* __restrict__ uplink_iso, int C, int S,
                 int hetero, double xi1, double xi2, double alpha,
                 double b_inter, double b_intra, double two_share,
                 double share, double reduce_const, double compute,
                 double iters, double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kScoreWarps +
                      (threadIdx.x >> 5);
  if (c >= C) return;  // the whole warp
  const int64_t* row = Y + c * S;
  int n_srv = 0;
  double speed = INFINITY, bw_sh = INFINITY, bw_iso = INFINITY;
  for (int s = lane; s < S; s += 32) {
    if (row[s] > 0) {
      ++n_srv;
      speed = fmin(speed, speed_floor[s]);
      bw_sh = fmin(bw_sh, uplink_sh[s]);
      bw_iso = fmin(bw_iso, uplink_iso[s]);
    }
  }
  n_srv = __reduce_add_sync(kFull, n_srv);
  speed = warp_min(speed);
  bw_sh = warp_min(bw_sh);
  bw_iso = warp_min(bw_iso);
  if (lane) return;
  // Eq. (7): k = max(xi1 * p, 1), f = k + alpha * (k - 1); gamma.
  double k = __dmul_rn(xi1, p[c]);
  if (k < 1.0) k = 1.0;
  const double f = __dadd_rn(k, __dmul_rn(alpha, __dsub_rn(k, 1.0)));
  const double gamma = __dmul_rn(xi2, static_cast<double>(n_srv));
  double bw_multi, reduce;
  if (hetero) {
    bw_multi = __ddiv_rn(bw_sh, f);  // min(bw_iso, bw_sh / f)
    if (bw_iso < bw_multi) bw_multi = bw_iso;
    reduce = __ddiv_rn(share, speed);
  } else {
    bw_multi = __ddiv_rn(b_inter, f);
    reduce = reduce_const;
  }
  const double bandwidth = n_srv > 1 ? bw_multi : b_intra;
  const double exchange = __ddiv_rn(two_share, bandwidth);
  const double tau =
      __dadd_rn(__dadd_rn(__dadd_rn(exchange, reduce), gamma), compute);
  double phi = floor(__ddiv_rn(1.0, tau));
  if (phi < 1.0) phi = 1.0;
  out[c] = tau;
  out[C + c] = ceil(__ddiv_rn(iters, phi));
}

}  // namespace

extern "C" {

int pool_stats(const void* U, const void* th_lo, const void* th_hi,
               const void* rho_u, const void* pid, long long G, double lam_G,
               const void* offsets, const void* caps, const void* gpu_server,
               int B, int N, int S, void* out, void* stream) {
  const int chunk = N < kChunk ? N : kChunk;
  const size_t smem =
      static_cast<size_t>(S) * (5 * sizeof(double) + 2 * sizeof(int)) +
      static_cast<size_t>(chunk) * sizeof(Key);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kSmemDefault)) {
    const cudaError_t err = cudaFuncSetAttribute(
        pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pool_kernel<<<B, kPoolThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(U), static_cast<const double*>(th_lo),
      static_cast<const double*>(th_hi), static_cast<const double*>(rho_u),
      static_cast<const int64_t*>(pid), G, lam_G,
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(caps),
      static_cast<const int64_t*>(gpu_server), B, N, S, chunk,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int score_rows(const void* Y, const void* p, const void* speed_floor,
               const void* uplink_sh, const void* uplink_iso, int C, int S,
               int hetero, double xi1, double xi2, double alpha,
               double b_inter, double b_intra, double two_share, double share,
               double reduce_const, double compute, double iters, void* out,
               void* stream) {
  const int blocks = (C + kScoreWarps - 1) / kScoreWarps;
  score_kernel<<<blocks, kScoreWarps * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(Y), static_cast<const double*>(p),
      static_cast<const double*>(speed_floor),
      static_cast<const double*>(uplink_sh),
      static_cast<const double*>(uplink_iso), C, S, hetero, xi1, xi2, alpha,
      b_inter, b_intra, two_share, share, reduce_const, compute, iters,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One pick_orders call: its packed inputs (U [B, N], th_lo, th_hi, rho_u
// [B] float64, pid [B] int64, in that order) copied up from a pinned host
// buffer, one pool_kernel launch, the first out_words words of the packed
// output copied back into a pinned host buffer, one wait on the stream.
int pool_step(const void* host_in, void* dev_in, long long G, double lam_G,
              const void* offsets, const void* caps, const void* gpu_server,
              int B, int N, int S, void* dev_out, void* host_out,
              long long out_words, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long BN = static_cast<long long>(B) * N;
  cudaError_t err =
      cudaMemcpyAsync(dev_in, host_in, (BN + 4LL * B) * sizeof(double),
                      cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const double* U = static_cast<const double*>(dev_in);
  const int launched =
      pool_stats(U, U + BN, U + BN + B, U + BN + 2 * B, U + BN + 3 * B, G,
                 lam_G, offsets, caps, gpu_server, B, N, S, dev_out, stream);
  if (launched) return launched;
  err = cudaMemcpyAsync(host_out, dev_out, out_words * sizeof(int64_t),
                        cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(st));
}

// One score_probes call: Y [C, S] int64 then p [C] float64 copied up, one
// score_kernel launch, tau then rho [C] float64 copied back, one wait.
int score_step(const void* host_in, void* dev_in, const void* speed_floor,
               const void* uplink_sh, const void* uplink_iso, int C, int S,
               int hetero, double xi1, double xi2, double alpha,
               double b_inter, double b_intra, double two_share, double share,
               double reduce_const, double compute, double iters,
               void* dev_out, void* host_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long CS = static_cast<long long>(C) * S;
  cudaError_t err = cudaMemcpyAsync(dev_in, host_in, (CS + C) * sizeof(int64_t),
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t* Y = static_cast<const int64_t*>(dev_in);
  const int launched = score_rows(
      Y, Y + CS, speed_floor, uplink_sh, uplink_iso, C, S, hetero, xi1, xi2,
      alpha, b_inter, b_intra, two_share, share, reduce_const, compute, iters,
      dev_out, stream);
  if (launched) return launched;
  err = cudaMemcpyAsync(host_out, dev_out, 2LL * C * sizeof(double),
                        cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(st));
}

const char* placement_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Columnar placement step kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels _pool_kernel and _score_kernel of
// src/repro/kernels/placement.py (row math _pool_row_math and
// _score_row_math).
//
// pool_kernel, one block per work row b of the busy-time clocks U [B, N]:
//   * threads over the N GPUs compute V = U + rho/u and the Eq. (16) pool
//     counts V <= theta + 1e-9 at the row's two extreme thetas (integer
//     block reduction: exact in any order);
//   * then one thread per server walks that server's contiguous GPU range
//     in GPU-id order, summing the busy clocks with explicit __dadd_rn in
//     the same sequence np.bincount(gpu_server, weights=U) uses, and
//     counting the feasible slots;
//   * then one warp picks the FA-FFP best server by an exact lexicographic
//     argmin over (feasible slots left, -load, server id): servers where
//     the job does not fit rank last, and ties go to the smallest id, as
//     the reference's staged masked argmins do.
//   The feasibility mask itself is not written back: the host recomputes
//   it from V with one compare, as the reference does.
//
// score_kernel, one thread per probed candidate row of Y [B, S]: the
//   Eq. (8) tau from the host-computed degradation f and gamma (the
//   multiplies that would feed an addition stay on the host, as in the
//   reference), with the heterogeneous masked minima over the row's
//   occupied servers, then phi = max(1, floor(1/tau)) and the rho-hat slot
//   count ceil(iters/phi).
//
// Bound: at the scheduler's shapes (B ~ 64 rows of N ~ 300 clocks, S ~ 20
// servers: ~150 KB in, less out) launch latency and the host<->device
// copies dominate; the card's bytes and operations are negligible.  The
// design is therefore the plain one and spends its care on bit-identity
// (no FMA contraction: __d*_rn intrinsics plus -fmad=false; no
// reassociated float sums; first-index tie-breaks).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPoolThreads = 256;
constexpr int kScoreThreads = 128;

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

__global__ void pool_kernel(const double* __restrict__ U,
                            const double* __restrict__ th_lo,
                            const double* __restrict__ th_hi,
                            const double* __restrict__ rho_u, long long G,
                            const int64_t* __restrict__ offsets,
                            const int64_t* __restrict__ caps, int N, int S,
                            double* __restrict__ V,
                            int64_t* __restrict__ c_lo,
                            int64_t* __restrict__ c_hi,
                            double* __restrict__ load,
                            int64_t* __restrict__ cnt,
                            int64_t* __restrict__ best_srv,
                            bool* __restrict__ has_fit) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_load = reinterpret_cast<double*>(smem);               // [S]
  long long* s_cnt = reinterpret_cast<long long*>(s_load + S);    // [S]
  __shared__ int s_lo, s_hi;
  const long long b = blockIdx.x;
  const double* u = U + b * N;
  const double ru = rho_u[b];
  const double lo = __dadd_rn(th_lo[b], 1e-9);
  const double hi = __dadd_rn(th_hi[b], 1e-9);
  if (threadIdx.x == 0) {
    s_lo = 0;
    s_hi = 0;
  }
  __syncthreads();

  int my_lo = 0, my_hi = 0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const double v = __dadd_rn(u[i], ru);
    V[b * N + i] = v;
    my_lo += v <= lo;
    my_hi += v <= hi;
  }
  atomicAdd(&s_lo, my_lo);
  atomicAdd(&s_hi, my_hi);

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const long long first = offsets[s], last = first + caps[s];
    double acc = 0.0;
    long long k = 0;
    for (long long i = first; i < last; ++i) {  // GPU-id order
      acc = __dadd_rn(acc, u[i]);
      k += __dadd_rn(u[i], ru) <= lo;
    }
    s_load[s] = acc;
    s_cnt[s] = k;
    load[b * S + s] = acc;
    cnt[b * S + s] = k;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    c_lo[b] = s_lo;
    c_hi[b] = s_hi;
  }
  if (threadIdx.x < 32) {
    Best best = {LLONG_MAX, INFINITY, INT_MAX};
    for (int s = threadIdx.x; s < S; s += 32) {
      const bool fits = s_cnt[s] >= G;
      const Best mine = {fits ? s_cnt[s] - G : static_cast<long long>(N) + 1,
                         fits ? -s_load[s] : INFINITY, s};
      if (before(mine, best)) best = mine;
    }
    for (int off = 16; off > 0; off >>= 1) {
      Best other;
      other.slots_left = __shfl_xor_sync(0xffffffffu, best.slots_left, off);
      other.neg_load = __shfl_xor_sync(0xffffffffu, best.neg_load, off);
      other.id = __shfl_xor_sync(0xffffffffu, best.id, off);
      if (before(other, best)) best = other;
    }
    if (threadIdx.x == 0) {
      best_srv[b] = best.id;
      has_fit[b] = best.slots_left <= N;
    }
  }
}

// scalars: (2 * share, share, share / gpu_speed, compute, iters).
__global__ void score_kernel(const int64_t* __restrict__ Y,
                             const double* __restrict__ f,
                             const double* __restrict__ gamma,
                             const double* __restrict__ scalars,
                             const double* __restrict__ speed_floor,
                             const double* __restrict__ uplink_sh,
                             const double* __restrict__ uplink_iso, int B,
                             int S, int hetero, double b_inter,
                             double b_intra, double* __restrict__ tau_out,
                             double* __restrict__ rho_out) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (b >= B) return;
  const int64_t* row = Y + b * S;
  int n_srv = 0;
  double speed = INFINITY, bw_sh = INFINITY, bw_iso = INFINITY;
  for (int s = 0; s < S; ++s) {
    if (row[s] > 0) {
      ++n_srv;
      speed = fmin(speed, speed_floor[s]);
      bw_sh = fmin(bw_sh, uplink_sh[s]);
      bw_iso = fmin(bw_iso, uplink_iso[s]);
    }
  }
  const double two_share = scalars[0], share = scalars[1];
  double bw_multi, reduce;
  if (hetero) {
    bw_multi = __ddiv_rn(bw_sh, f[b]);  // min(bw_iso, bw_sh / f)
    if (bw_iso < bw_multi) bw_multi = bw_iso;
    reduce = __ddiv_rn(share, speed);
  } else {
    bw_multi = __ddiv_rn(b_inter, f[b]);
    reduce = scalars[2];
  }
  const double bandwidth = n_srv > 1 ? bw_multi : b_intra;
  const double exchange = __ddiv_rn(two_share, bandwidth);
  const double tau =
      __dadd_rn(__dadd_rn(__dadd_rn(exchange, reduce), gamma[b]), scalars[3]);
  double phi = floor(__ddiv_rn(1.0, tau));
  if (phi < 1.0) phi = 1.0;
  tau_out[b] = tau;
  rho_out[b] = ceil(__ddiv_rn(scalars[4], phi));
}

}  // namespace

extern "C" {

int pool_stats(const void* U, const void* th_lo, const void* th_hi,
               const void* rho_u, long long G, const void* offsets,
               const void* caps, void* V, void* c_lo, void* c_hi, void* load,
               void* cnt, void* best_srv, void* has_fit, int B, int N, int S,
               void* stream) {
  const size_t smem = static_cast<size_t>(S) * (sizeof(double) +
                                                sizeof(long long));
  pool_kernel<<<B, kPoolThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(U), static_cast<const double*>(th_lo),
      static_cast<const double*>(th_hi), static_cast<const double*>(rho_u), G,
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(caps),
      N, S, static_cast<double*>(V), static_cast<int64_t*>(c_lo),
      static_cast<int64_t*>(c_hi), static_cast<double*>(load),
      static_cast<int64_t*>(cnt), static_cast<int64_t*>(best_srv),
      static_cast<bool*>(has_fit));
  return static_cast<int>(cudaGetLastError());
}

int score_rows(const void* Y, const void* f, const void* gamma,
               const void* scalars, const void* speed_floor,
               const void* uplink_sh, const void* uplink_iso, void* tau,
               void* rho, int B, int S, int hetero, double b_inter,
               double b_intra, void* stream) {
  const int blocks = (B + kScoreThreads - 1) / kScoreThreads;
  score_kernel<<<blocks, kScoreThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(Y), static_cast<const double*>(f),
      static_cast<const double*>(gamma), static_cast<const double*>(scalars),
      static_cast<const double*>(speed_floor),
      static_cast<const double*>(uplink_sh),
      static_cast<const double*>(uplink_iso), B, S, hetero, b_inter, b_intra,
      static_cast<double*>(tau), static_cast<double*>(rho));
  return static_cast<int>(cudaGetLastError());
}

const char* placement_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

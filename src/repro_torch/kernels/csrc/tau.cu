// Eq. (6)-(8) candidate-stack reduction for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels _tau_kernel (homogeneous cluster, K1) and
// _tau_kernel_het (heterogeneous cluster, K2) of src/repro/kernels/tau.py
// (:75 and :40).  For each candidate c of a stack Y [C, J, S] (GPUs of job
// j on server s) it computes the Eq. (6) straddle mask 0 < y < G_j, the
// per-server straddler counts, each job's contention level p (the max
// count over its straddled servers), its server spread n_srv and the
// Eq. (8) per-iteration time tau.  The heterogeneous variant also takes
// the masked minima of the per-server speed floor and shared/isolated
// uplink bandwidths over each job's occupied servers.
//
// Bound: bytes.  The stack is read once and three [C, J] outputs written
// once: at the §7 shape (C = 64, J = 161, S = 20) 2.1 MB, 0.64 us at 3.35
// TB/s; the float64 arithmetic is a few operations per element.  What the
// card actually waits on is latency: a candidate's work is a few thousand
// elements, so the kernel runs one block per candidate (64 blocks) and
// spends its threads, not more blocks, on it.  Each block of 256 threads:
//   * stages the candidate's G_j (one read per row) and, for K2, the
//     per-server speed floors and uplinks in shared memory;
//   * reads its contiguous [J, S] int64 slice once, coalesced, all
//     threads together (16 independent loads in flight a thread), into
//     one flag byte per element in shared memory: bit 0 occupied (y > 0),
//     bit 1 straddled (0 < y < G_j); each straddled element adds one to
//     its server's count with a shared-memory integer atomic (exact in
//     any order);
//   * then one thread per job reads its row's flags for p, n_srv and the
//     masked minima (selections, order-free) and prices Eq. (8) with every
//     rounding explicit (__dmul_rn/__dadd_rn/__ddiv_rn are never
//     contracted into an FMA; the build also passes -fmad=false), in the
//     NumPy order: f = k + alpha*(k-1), tau = ((2*share)/bw + reduce) +
//     gamma + compute.
// The flags and staged G_j of a stack stay in shared memory whole while
// the block's shared memory fits in 48 KB: 3.2 KB of flags at the §7
// shape, 32.8 KB at the |J| = 1024 scale point (J = 1025, S = 32).  A
// larger stack is taken in chunks of rows: one pass over all chunks for
// the counts, a second that rebuilds each chunk's flags for the rows'
// outputs.  Both paths give the same bits.
//
// What the caller waits on, though, is the round trip around the ~7 us
// kernel: the host's inputs go up, the outputs come back, and the host
// waits for them.  So tau_step_hom / tau_step_het below make the whole of
// one tau_stack call in one call from the wrapper: one copy up of the
// packed inputs (Y, G, share, compute in one buffer of int64 words) from a
// pinned host buffer, one launch, one copy back of p, n_srv and tau into
// another pinned host buffer, and one wait on the stream.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
// Shared memory a block fills before it takes the stack in chunks of rows.
constexpr int kSmemBudget = 48 * 1024;
// Dynamic shared memory a launch may ask for (the H100's per-block limit).
constexpr int kMaxSmem = 227 * 1024;

// Eq. (7) and the degradation f(alpha, k) = k + alpha * (k - 1).
__device__ __forceinline__ double degradation(double xi1, double alpha,
                                              long long p) {
  double k = __dmul_rn(xi1, static_cast<double>(p));
  if (k < 1.0) k = 1.0;
  return __dadd_rn(k, __dmul_rn(alpha, __dsub_rn(k, 1.0)));
}

// Flag bytes of rows [r0, r0 + rows) of one candidate's slice y: G_j goes
// to gs first (one read per row), then every element once, coalesced, with
// kUnroll independent loads in flight a thread.  With `count`, each
// straddled element also adds one to its server's count (a shared-memory
// integer atomic: exact in any order).
__device__ __forceinline__ void build_flags(const int64_t* __restrict__ y,
                                            const int64_t* __restrict__ g,
                                            int64_t* gs, uint8_t* flags,
                                            int* per_server, bool count,
                                            int r0, int rows, int S) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) gs[r] = g[r0 + r];
  __syncthreads();
  const int n = rows * S;
  const int64_t* base = y + static_cast<long long>(r0) * S;
  constexpr int kUnroll = 16;
  for (int e0 = threadIdx.x; e0 < n; e0 += kUnroll * kThreads) {
    int64_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      v[u] = e < n ? base[e] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) {
        const int r = e / S;
        const bool pos = v[u] > 0, straddle = pos && v[u] < gs[r];
        flags[e] = static_cast<uint8_t>(pos | (straddle << 1));
        if (count && straddle) atomicAdd(&per_server[e - r * S], 1);
      }
    }
  }
  __syncthreads();
}

template <bool kHetero>
__global__ void __launch_bounds__(kThreads)
    tau_kernel(const int64_t* __restrict__ Y, const int64_t* __restrict__ G,
               const double* __restrict__ share,
               const double* __restrict__ compute,
               const double* __restrict__ speed_floor,
               const double* __restrict__ uplink_sh,
               const double* __restrict__ uplink_iso,
               int64_t* __restrict__ p_out, int64_t* __restrict__ n_out,
               double* __restrict__ tau_out, int J, int S, int chunk,
               long long term_stride, double xi1, double xi2, double alpha,
               double b_inter, double b_intra, double gpu_speed) {
  // [S] K2 server terms (3 x double), [chunk] staged G_j, [S] counts,
  // [chunk * S] flags.
  extern __shared__ __align__(16) unsigned char smem[];
  double* speed_s = reinterpret_cast<double*>(smem);
  double* bw_sh_s = speed_s + (kHetero ? S : 0);
  double* bw_iso_s = bw_sh_s + (kHetero ? S : 0);
  int64_t* gs = reinterpret_cast<int64_t*>(bw_iso_s + (kHetero ? S : 0));
  int* per_server = reinterpret_cast<int*>(gs + chunk);
  uint8_t* flags = reinterpret_cast<uint8_t*>(per_server + S);

  const long long c = blockIdx.x;
  const int64_t* y = Y + c * J * static_cast<long long>(S);
  const int64_t* g = G + c * term_stride;
  const double* sh = share + c * term_stride;
  const double* cp = compute + c * term_stride;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    per_server[s] = 0;
    if (kHetero) {
      speed_s[s] = speed_floor[s];
      bw_sh_s[s] = uplink_sh[s];
      bw_iso_s[s] = uplink_iso[s];
    }
  }
  // (build_flags starts with a barrier-separated step, so the zeroed
  // counts are visible before any thread adds to them.)

  // Pass 1: flags and per-server straddler counts over all rows.
  for (int r0 = 0; r0 < J; r0 += chunk)
    build_flags(y, g, gs, flags, per_server, true, r0, min(chunk, J - r0),
                S);

  // Pass 2: each job's p, n_srv and tau from its row's flags.  The last
  // chunk's flags are still in place, so a one-chunk stack is read once.
  const int last = ((J - 1) / chunk) * chunk;
  for (int r0 = last; r0 >= 0; r0 -= chunk) {
    const int rows = min(chunk, J - r0);
    if (r0 != last)
      build_flags(y, g, gs, flags, per_server, false, r0, rows, S);
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int j = r0 + r;
      const double share_j = sh[j], compute_j = cp[j];  // in flight early
      const uint8_t* row = flags + r * S;
      long long p = 0, n_srv = 0;
      double speed = INFINITY, bw_sh = INFINITY, bw_iso = INFINITY;
      for (int s = 0; s < S; ++s) {
        const uint8_t f = row[s];
        if (f) {
          ++n_srv;
          if ((f & 2) && per_server[s] > p) p = per_server[s];
          if (kHetero) {
            speed = fmin(speed, speed_s[s]);
            bw_sh = fmin(bw_sh, bw_sh_s[s]);
            bw_iso = fmin(bw_iso, bw_iso_s[s]);
          }
        }
      }
      const double f = degradation(xi1, alpha, p);
      double bandwidth = b_intra;
      if (n_srv > 1) {
        if (kHetero) {
          bandwidth = __ddiv_rn(bw_sh, f);  // min(bw_iso, bw_sh / f)
          if (bw_iso < bandwidth) bandwidth = bw_iso;
        } else {
          bandwidth = __ddiv_rn(b_inter, f);
        }
      }
      const double gamma = __dmul_rn(xi2, static_cast<double>(n_srv));
      const double exchange = __ddiv_rn(__dmul_rn(2.0, share_j), bandwidth);
      const double reduce = __ddiv_rn(share_j, kHetero ? speed : gpu_speed);
      const long long o = c * J + j;
      p_out[o] = p;
      n_out[o] = n_srv;
      tau_out[o] = __dadd_rn(__dadd_rn(__dadd_rn(exchange, reduce), gamma),
                             compute_j);
    }
    __syncthreads();  // the rows are read before the next chunk's flags
  }
}

// The launch: as many rows a chunk as the shared-memory budget holds
// (at least one), and the dynamic shared memory they take.
template <bool kHetero>
int launch(const void* Y, const void* G, const void* share,
           const void* compute, const void* speed_floor,
           const void* uplink_sh, const void* uplink_iso, void* p,
           void* n_srv, void* tau, int C, int J, int S,
           long long term_stride, double xi1, double xi2, double alpha,
           double b_inter, double b_intra, double gpu_speed,
           cudaStream_t stream) {
  if (C <= 0 || J <= 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long fixed = (kHetero ? 3LL * S * sizeof(double) : 0) +
                          static_cast<long long>(S) * sizeof(int);
  const long long per_row = S + static_cast<long long>(sizeof(int64_t));
  const int chunk = static_cast<int>(
      std::min<long long>(J, std::max(1LL, (kSmemBudget - fixed) / per_row)));
  const long long smem = fixed + chunk * per_row;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemBudget) {
    const cudaError_t err = cudaFuncSetAttribute(
        tau_kernel<kHetero>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tau_kernel<kHetero><<<C, kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const int64_t*>(Y), static_cast<const int64_t*>(G),
      static_cast<const double*>(share), static_cast<const double*>(compute),
      static_cast<const double*>(speed_floor),
      static_cast<const double*>(uplink_sh),
      static_cast<const double*>(uplink_iso), static_cast<int64_t*>(p),
      static_cast<int64_t*>(n_srv), static_cast<double*>(tau), J, S, chunk,
      term_stride, xi1, xi2, alpha, b_inter, b_intra, gpu_speed);
  return static_cast<int>(cudaGetLastError());
}

// One round trip: copy up, launch, copy back, wait (see tau_step_hom).  A
// failed launch still waits, so the caller may reuse host_in at once.
template <bool kHetero>
int step(const void* host_in, void* dev_in, long long in_words,
         long long g_off, long long share_off, long long compute_off,
         const void* speed_floor, const void* uplink_sh,
         const void* uplink_iso, void* dev_out, void* host_out, int C, int J,
         int S, long long term_stride, double xi1, double xi2, double alpha,
         double b_inter, double b_intra, double gpu_speed,
         cudaStream_t stream) {
  cudaError_t err =
      cudaMemcpyAsync(dev_in, host_in, in_words * sizeof(int64_t),
                      cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t* in = static_cast<const int64_t*>(dev_in);
  int64_t* out = static_cast<int64_t*>(dev_out);
  const long long CJ = static_cast<long long>(C) * J;
  const int launched = launch<kHetero>(
      in, in + g_off, in + share_off, in + compute_off, speed_floor,
      uplink_sh, uplink_iso, out, out + CJ, out + 2 * CJ, C, J, S,
      term_stride, xi1, xi2, alpha, b_inter, b_intra, gpu_speed, stream);
  if (launched) {
    cudaStreamSynchronize(stream);
    return launched;
  }
  err = cudaMemcpyAsync(host_out, dev_out, 3 * CJ * sizeof(int64_t),
                        cudaMemcpyDeviceToHost, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(stream));
}

}  // namespace

extern "C" {

// Homogeneous stack (K1).  term_stride is J for per-candidate [C, J] terms
// and 0 for terms shared across the stack ([J]).
int tau_stack_hom(const void* Y, const void* G, const void* share,
                  const void* compute, void* p, void* n_srv, void* tau, int C,
                  int J, int S, long long term_stride, double xi1, double xi2,
                  double alpha, double b_inter, double b_intra,
                  double gpu_speed, void* stream) {
  return launch<false>(Y, G, share, compute, nullptr, nullptr, nullptr, p,
                       n_srv, tau, C, J, S, term_stride, xi1, xi2, alpha,
                       b_inter, b_intra, gpu_speed,
                       static_cast<cudaStream_t>(stream));
}

// Heterogeneous stack (K2): per-server speed floors and shared/isolated
// uplinks (+inf where the class is absent), each [S].
int tau_stack_het(const void* Y, const void* G, const void* share,
                  const void* compute, const void* speed_floor,
                  const void* uplink_sh, const void* uplink_iso, void* p,
                  void* n_srv, void* tau, int C, int J, int S,
                  long long term_stride, double xi1, double xi2, double alpha,
                  double b_intra, void* stream) {
  return launch<true>(Y, G, share, compute, speed_floor, uplink_sh,
                      uplink_iso, p, n_srv, tau, C, J, S, term_stride, xi1,
                      xi2, alpha, 0.0, b_intra, 0.0,
                      static_cast<cudaStream_t>(stream));
}

// One tau_stack call (K1): in_words packed words copied up from the pinned
// host_in into dev_in -- Y [C, J, S] int64 from word 0, then G int64,
// share and compute float64 from words g_off, share_off and compute_off
// (each [J], term_stride 0, or [C, J], term_stride J) -- one launch writing
// p, n_srv and tau [C, J] one after the other into dev_out, those 3 * C * J
// words copied back into the pinned host_out, one wait on the stream.
int tau_step_hom(const void* host_in, void* dev_in, long long in_words,
                 long long g_off, long long share_off, long long compute_off,
                 void* dev_out, void* host_out, int C, int J, int S,
                 long long term_stride, double xi1, double xi2, double alpha,
                 double b_inter, double b_intra, double gpu_speed,
                 void* stream) {
  return step<false>(host_in, dev_in, in_words, g_off, share_off,
                     compute_off, nullptr, nullptr, nullptr, dev_out,
                     host_out, C, J, S, term_stride, xi1, xi2, alpha,
                     b_inter, b_intra, gpu_speed,
                     static_cast<cudaStream_t>(stream));
}

// The same for a heterogeneous stack (K2), with the cluster's per-server
// speed floors and shared/isolated uplinks ([S] float64 on the device).
int tau_step_het(const void* host_in, void* dev_in, long long in_words,
                 long long g_off, long long share_off, long long compute_off,
                 const void* speed_floor, const void* uplink_sh,
                 const void* uplink_iso, void* dev_out, void* host_out, int C,
                 int J, int S, long long term_stride, double xi1, double xi2,
                 double alpha, double b_intra, void* stream) {
  return step<true>(host_in, dev_in, in_words, g_off, share_off, compute_off,
                    speed_floor, uplink_sh, uplink_iso, dev_out, host_out, C,
                    J, S, term_stride, xi1, xi2, alpha, 0.0, b_intra, 0.0,
                    static_cast<cudaStream_t>(stream));
}

const char* tau_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Eq. (6)-(8) candidate-stack reduction for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels _tau_kernel (homogeneous cluster) and
// _tau_kernel_het (heterogeneous cluster) of src/repro/kernels/tau.py.
// For each candidate c of a stack Y [C, J, S] (GPUs of job j on server s)
// it computes the Eq. (6) straddle mask 0 < y < G_j, the per-server
// straddler counts, each job's contention level p (the max count over its
// straddled servers), its server spread n_srv and the Eq. (8) per-iteration
// time tau.  The heterogeneous variant also takes the masked minima of the
// per-server speed floor and shared/isolated uplink bandwidths over each
// job's occupied servers.
//
// Bound: at the scheduler's shapes (C ~ 64, J ~ 160, S ~ 20: a few hundred
// KB of int64 occupancy) the launch latency and the host<->device copies
// around it dominate; the arithmetic and the bytes are negligible for the
// card.  So the design is the simple one: one block per candidate, no
// tiling, and all effort goes to bit-identity with the float64 NumPy
// engines:
//   * phase 1: threads stride over servers; each sums its server's
//     straddle count over the J rows (an integer sum, exact in any order)
//     into shared memory;
//   * phase 2: threads stride over jobs; each walks its row once for p,
//     n_srv and the masked minima (selections, order-free), then prices
//     Eq. (8) with every rounding explicit (__dmul_rn/__dadd_rn/__ddiv_rn
//     are never contracted into an FMA; the build also passes
//     -fmad=false), in the NumPy order: f = k + alpha*(k-1),
//     tau = ((2*share)/bw + reduce) + gamma + compute.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// Eq. (7) and the degradation f(alpha, k) = k + alpha * (k - 1).
__device__ __forceinline__ double degradation(double xi1, double alpha,
                                              long long p) {
  double k = __dmul_rn(xi1, static_cast<double>(p));
  if (k < 1.0) k = 1.0;
  return __dadd_rn(k, __dmul_rn(alpha, __dsub_rn(k, 1.0)));
}

template <bool kHetero>
__global__ void tau_kernel(const int64_t* __restrict__ Y,
                           const int64_t* __restrict__ G,
                           const double* __restrict__ share,
                           const double* __restrict__ compute,
                           const double* __restrict__ speed_floor,
                           const double* __restrict__ uplink_sh,
                           const double* __restrict__ uplink_iso,
                           int64_t* __restrict__ p_out,
                           int64_t* __restrict__ n_out,
                           double* __restrict__ tau_out, int J, int S,
                           long long term_stride, double xi1, double xi2,
                           double alpha, double b_inter, double b_intra,
                           double gpu_speed) {
  extern __shared__ int per_server[];  // [S] Eq. (6) straddler counts
  const long long c = blockIdx.x;
  const int64_t* y = Y + c * J * static_cast<long long>(S);
  const int64_t* g = G + c * term_stride;
  const double* sh = share + c * term_stride;
  const double* cp = compute + c * term_stride;

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int count = 0;
    for (int j = 0; j < J; ++j) {
      const int64_t v = y[static_cast<long long>(j) * S + s];
      count += (v > 0 && v < g[j]);
    }
    per_server[s] = count;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const int64_t* row = y + static_cast<long long>(j) * S;
    const int64_t gj = g[j];
    long long p = 0, n_srv = 0;
    double speed = INFINITY, bw_sh = INFINITY, bw_iso = INFINITY;
    for (int s = 0; s < S; ++s) {
      const int64_t v = row[s];
      if (v > 0) {
        ++n_srv;
        if (v < gj && per_server[s] > p) p = per_server[s];
        if (kHetero) {
          speed = fmin(speed, speed_floor[s]);
          bw_sh = fmin(bw_sh, uplink_sh[s]);
          bw_iso = fmin(bw_iso, uplink_iso[s]);
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
    const double exchange = __ddiv_rn(__dmul_rn(2.0, sh[j]), bandwidth);
    const double reduce = __ddiv_rn(sh[j], kHetero ? speed : gpu_speed);
    const long long o = c * J + j;
    p_out[o] = p;
    n_out[o] = n_srv;
    tau_out[o] = __dadd_rn(__dadd_rn(__dadd_rn(exchange, reduce), gamma),
                           cp[j]);
  }
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
  tau_kernel<false><<<C, kThreads, S * sizeof(int),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(Y), static_cast<const int64_t*>(G),
      static_cast<const double*>(share), static_cast<const double*>(compute),
      nullptr, nullptr, nullptr, static_cast<int64_t*>(p),
      static_cast<int64_t*>(n_srv), static_cast<double*>(tau), J, S,
      term_stride, xi1, xi2, alpha, b_inter, b_intra, gpu_speed);
  return static_cast<int>(cudaGetLastError());
}

// Heterogeneous stack (K2): per-server speed floors and shared/isolated
// uplinks (+inf where the class is absent), each [S].
int tau_stack_het(const void* Y, const void* G, const void* share,
                  const void* compute, const void* speed_floor,
                  const void* uplink_sh, const void* uplink_iso, void* p,
                  void* n_srv, void* tau, int C, int J, int S,
                  long long term_stride, double xi1, double xi2, double alpha,
                  double b_intra, void* stream) {
  tau_kernel<true><<<C, kThreads, S * sizeof(int),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(Y), static_cast<const int64_t*>(G),
      static_cast<const double*>(share), static_cast<const double*>(compute),
      static_cast<const double*>(speed_floor),
      static_cast<const double*>(uplink_sh),
      static_cast<const double*>(uplink_iso), static_cast<int64_t*>(p),
      static_cast<int64_t*>(n_srv), static_cast<double*>(tau), J, S,
      term_stride, xi1, xi2, alpha, 0.0, b_intra, 0.0);
  return static_cast<int>(cudaGetLastError());
}

const char* tau_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

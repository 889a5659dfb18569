// The mLSTM parallel form (K6) with both products as 3xTF32 on the tensor
// cores: a design probe, not the port's kernel (that is
// src/repro_torch/kernels/csrc/mlstm.cu, which it shares its function,
// entry point and C signature with).  chip_probes/k6_design.py builds it
// and holds it against the plain version and the model's per-block gate.
//
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, a_hi = tf32(a) rounded to
// nearest, a_lo = a - a_hi with its low 13 bits cleared (or, with RNA_LO,
// rounded to nearest), on mma.sync m16n8k8 with fp32 accumulators.  One
// block of 8 warps per (batch * head, query tile of 64 rows); warp w holds
// rows 16 (w / 2) .. + 15 and, in S v, columns (w % 2) hd / 2 .. of the
// output; q.k of its rows against kv rows 16 (w % 2) .. + 15 of each kv
// tile of 32, the small and the big terms in separate accumulators, even
// and odd k-steps apart; P through shared memory.  The query tile stays in
// shared memory; kv tiles stream through a ring of 5 cp.async stages (k in
// 128 head-dim columns, v in 8 rows).  m is each row's exact max of D,
// found first from the gates.  Switches:
//   FLUSH     each k-step's products summed from zero and added to the
//             accumulators in fp32 (the tensor core's adds truncate);
//   RNA_LO    a_lo rounded to nearest instead of toward zero;
//   FOURTERM  the fourth product a_lo b_lo as well.
// Every row of q, k and v must start on 16 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 64;               // query rows a block: 4 groups of 16
constexpr int BK = 32;               // kv rows a tile: 2 groups of 16
constexpr int LDP = BK + 4;          // P row stride
constexpr int kStages = 5;           // the ring of k and v stages
constexpr int kMaxSmem = 232448;     // dynamic shared memory of a block

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* f;
  const float* ig;
  void* o;
  long long q_sb, q_sh, q_ss;  // element strides: batch, head, sequence
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long f_sb, f_sh, f_ss;
  long long i_sb, i_sh, i_ss;
  long long o_sb, o_sh, o_ss;
  int H, S;
};

template <int HD>
struct Tiling {
  static constexpr int DC = HD < 128 ? HD : 128;  // head-dim columns: k stage
  static constexpr int NK = HD / DC;              // k stages a kv tile
  static constexpr int kItems = NK + BK / 8;      // + a v stage a k-step
  static constexpr int LDQ = HD + 4;              // = 4 (mod 32)
  static constexpr int LDK = DC + 4;              // = 4 (mod 32)
  static constexpr int LDV = HD + 8;              // = 8 (mod 32)
  static constexpr int kStage = BK * LDK > 8 * LDV ? BK * LDK : 8 * LDV;
  static constexpr int NV = HD / 16;              // 8-column blocks a warp
  static constexpr int kSmemFloats =
      BQ * LDQ + kStages * kStage + BQ * LDP + 4 * BK + 3 * BQ;
  static_assert(kSmemFloats * 4 <= kMaxSmem, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, or zeros when !in.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// x = hi + lo in TF32 (see the switches above).
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi,
                                      uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
#ifdef RNA_LO
  lo = (__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) +
        0x1000u) & 0xffffe000u;
#else
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) &
       0xffffe000u;
#endif
}

// d = a b for a 16 x 8 tf32 A (row), an 8 x 8 tf32 B (col), fp32 D.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// c += a b for a 16 x 8 tf32 A (row), an 8 x 8 tf32 B (col), fp32 C.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + R) of a global tensor with row stride ss, columns
// [c0, c0 + W), into shared rows of stride LD; rows at or past lim read 0.
template <int R, int W, int LD>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long ss, int r0, int c0,
                                          int lim) {
  constexpr int C4 = W / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < R * C4; e += kThreads) {
    const int r = e / C4, cc = (e % C4) * 4;
    const bool in = r0 + r < lim;
    cp_async16(smem_addr(dst + r * LD + cc),
               src + (in ? (r0 + r) * ss : 0) + c0 + cc, in);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1) mlstm_tc_kernel(Args a) {
  using Tl = Tiling<HD>;
  constexpr int DC = Tl::DC, NK = Tl::NK, kItems = Tl::kItems,
                LDQ = Tl::LDQ, LDK = Tl::LDK, LDV = Tl::LDV,
                kStage = Tl::kStage, NV = Tl::NV;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                   // [BQ][LDQ]
  float* ring = sQ + BQ * LDQ;        // [kStages][kStage]: k and v stages
  float* sP = ring + kStages * kStage;  // [BQ][LDP]: this tile's P
  float* sG = sP + BQ * LDP;          // [2][F, i][BK]: a kv tile's gates
  float* sM = sG + 4 * BK;            // [BQ]: each row's m
  float* sD = sM + BQ;                // [2][BQ]: denominators a column group

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;  // row group, column group
  const int grp = lane / 4, tig = lane % 4;  // C fragment: row, column pair
  const int wq0 = q0 + 16 * wr;              // this warp's first row

  const float* q = a.q + b * a.q_sb + h * a.q_sh;
  const float* k = a.k + b * a.k_sb + h * a.k_sh;
  const float* v = a.v + b * a.v_sb + h * a.v_sh;
  const float* f = a.f + b * a.f_sb + h * a.f_sh;
  const float* ig = a.ig + b * a.i_sb + h * a.i_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  // Kv rows any row of this tile can see: [0, min(q0 + BQ, S)).
  const int kv_end = min(q0 + BQ, a.S);
  const int n_tiles = (kv_end + BK - 1) / BK;

  // Stage n of the stream: kv tile n / kItems; its k columns [DC i, DC i +
  // DC) for item i < NK (the first with the tile's gates), else its v rows
  // [8 (i - NK), + 8).  One cp.async group a stage, empty past the end.
  auto load_stage = [&](int n) {
    const int tile = n / kItems, item = n % kItems;
    if (tile < n_tiles) {
      float* dst = ring + (n % kStages) * kStage;
      const int k0 = tile * BK;
      if (item < NK) {
        copy_rows<BK, DC, LDK>(dst, k, a.k_ss, k0, item * DC, kv_end);
        if (item == 0 && tid < BK) {
          const int s = k0 + tid;
          const bool in = s < kv_end;
          float* g = sG + (tile & 1) * 2 * BK;
          cp_async4(smem_addr(g + tid), f + (in ? s * a.f_ss : 0), in);
          cp_async4(smem_addr(g + BK + tid), ig + (in ? s * a.i_ss : 0), in);
        }
      } else {
        copy_rows<8, HD, LDV>(dst, v, a.v_ss, k0 + 8 * (item - NK), 0,
                              kv_end);
      }
    }
    cp_async_commit();
  };

  // The query tile (with stage 0's group) and the first kStages - 1 stages.
  copy_rows<BQ, HD, LDQ>(sQ, q, a.q_ss, q0, 0, a.S);
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) load_stage(n);

  // m of each row while those loads fly: 4 threads a row, each over every
  // fourth visible s, the gates read through L1 (64 rows read the same
  // ones).
  {
    const int row = tid / 4, part = tid % 4;
    const int t = q0 + row;
    const float Ft = t < a.S ? f[t * a.f_ss] : 0.f;
    const int last = min(t, a.S - 1);  // the row's last visible s
    float mx = -1e30f;
    for (int s = part; s <= last; s += 4)
      mx = fmaxf(mx, Ft - f[s * a.f_ss] + ig[s * a.i_ss]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (part == 0) sM[row] = mx;
  }
  __syncthreads();
  // This thread's rows: grp and grp + 8 of the warp's 16.
  float Fq[2], m[2], den[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = wq0 + grp + 8 * i;
    Fq[i] = t < a.S ? f[t * a.f_ss] : 0.f;
    m[i] = sM[16 * wr + grp + 8 * i];
  }

  float acc[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // ldmatrix lane addresses.  A (q rows, P rows): row lane % 8 + 8 ((lane /
  // 8) % 2), column 4 (lane / 16); B (k rows, two n-blocks): row lane % 8 +
  // 8 (lane / 16), column 4 ((lane / 8) % 2).
  const int a_row = lane % 8 + 8 * ((lane / 8) % 2), a_col = 4 * (lane / 16);
  const uint32_t q_addr = smem_addr(sQ + (16 * wr + a_row) * LDQ + a_col);
  const uint32_t p_addr = smem_addr(sP + (16 * wr + a_row) * LDP + a_col);
  const uint32_t k_addr = smem_addr(ring + (16 * wc + lane % 8 +
                                            8 * (lane / 16)) * LDK +
                                    4 * ((lane / 8) % 2));
  // B (v, MN-major): kv row tig (and tig + 4), output column grp.
  const int v_off = tig * LDV + (HD / 2) * wc + grp;

  int n = 0;  // the stage computed next
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    // Some of this warp's 16 kv columns are visible to some of its rows.
    const bool live = k0 + 16 * wc <= wq0 + 15;

    // q.k of the warp's 16 rows x 16 kv rows: [n-block][k-step parity].
    float big[2][2][4], small[2][2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[j][p][e] = small[j][p][e] = 0.f;

    for (int kc = 0; kc < NK; ++kc, ++n) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage n is in; stage n - 1's slot is free
      load_stage(n + kStages - 1);
      if (!live) continue;
      const uint32_t qa = q_addr + kc * DC * 4;
      const uint32_t ka = k_addr + (n % kStages) * kStage * 4;
#pragma unroll
      for (int ks = 0; ks < DC / 8; ++ks) {
        uint32_t x[4], y[4], ah[4], al[4], bh[4], bl[4];
        ldmatrix_x4(x, qa + ks * 32);
        ldmatrix_x4(y, ka + ks * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split(x[e], ah[e], al[e]);
          split(y[e], bh[e], bl[e]);
        }
        const int p = ks % 2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#ifdef FLUSH
          float t[4];
          mma_tf32_zero(t, al, bh[2 * j], bh[2 * j + 1]);
#ifdef FOURTERM
          mma_tf32(t, al, bl[2 * j], bl[2 * j + 1]);
#endif
          mma_tf32(t, ah, bl[2 * j], bl[2 * j + 1]);
          mma_tf32(t, ah, bh[2 * j], bh[2 * j + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) big[j][p][e] += t[e];
#else
          mma_tf32(small[j][p], al, bh[2 * j], bh[2 * j + 1]);
#ifdef FOURTERM
          mma_tf32(small[j][p], al, bl[2 * j], bl[2 * j + 1]);
#endif
          mma_tf32(small[j][p], ah, bl[2 * j], bl[2 * j + 1]);
          mma_tf32(big[j][p], ah, bh[2 * j], bh[2 * j + 1]);
#endif
        }
      }
    }

    // P = (q.k) exp(D - m) where s <= t, else 0; into sP for both column
    // groups (read after the next stage's barrier), and into this thread's
    // part of the denominator.
    const float* gF = sG + (tile & 1) * 2 * BK;
    const float* gI = gF + BK;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = grp + 8 * i;                // in the warp's 16
        const int col = 16 * wc + 8 * j + 2 * tig;  // in the kv tile
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 2 * i + e;
          const int s = k0 + col + e, t = wq0 + row;
          const float qk = (big[j][0][x] + big[j][1][x]) +
                           (small[j][0][x] + small[j][1][x]);
          p[e] = 0.f;
          if (s <= t && s < a.S)
            p[e] = qk * expf(Fq[i] - gF[col + e] + gI[col + e] - m[i]);
          den[i] += p[e];
        }
        *reinterpret_cast<float2*>(sP + (16 * wr + row) * LDP + col) =
            make_float2(p[0], p[1]);
      }

    // acc += P v over this tile's kv rows, 8 (one v stage) at a time.
    for (int kk = 0; kk < BK / 8; ++kk, ++n) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage n (and, at kk = 0, P) is in
      load_stage(n + kStages - 1);
      if (k0 + 8 * kk > wq0 + 15) continue;  // all in these rows' future
      uint32_t x[4], ah[4], al[4];
      ldmatrix_x4(x, p_addr + kk * 32);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e], ah[e], al[e]);
      const float* vk = ring + (n % kStages) * kStage + v_off;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split(__float_as_uint(vk[8 * j]), bh0, bl0);
        split(__float_as_uint(vk[4 * LDV + 8 * j]), bh1, bl1);
#ifdef FLUSH
        float t[4];
        mma_tf32_zero(t, al, bh0, bh1);
#ifdef FOURTERM
        mma_tf32(t, al, bl0, bl1);
#endif
        mma_tf32(t, ah, bl0, bl1);
        mma_tf32(t, ah, bh0, bh1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += t[e];
#else
#ifdef FOURTERM
        mma_tf32(acc[j], al, bl0, bl1);
#endif
        mma_tf32(acc[j], al, bh0, bh1);
        mma_tf32(acc[j], ah, bl0, bl1);
        mma_tf32(acc[j], ah, bh0, bh1);
#endif
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit

  // The denominator: the 4 lanes of a quad, then the two column groups.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
    if (tig == 0) sD[wc * BQ + 16 * wr + grp + 8 * i] = den[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * wr + grp + 8 * i;
    const long long t = q0 + row;
    if (t >= a.S) continue;
    const float norm = fmaxf(fabsf(sD[row] + sD[BQ + row]), expf(-m[i]));
    T* orow = o + t * a.o_ss + (HD / 2) * wc + 2 * tig;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      store(orow + 8 * j, acc[j][2 * i] / norm);
      store(orow + 8 * j + 1, acc[j][2 * i + 1] / norm);
    }
  }
}

template <typename T, int HD>
int launch(const Args& a, int BH, cudaStream_t stream) {
  const int smem = Tiling<HD>::kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_tc_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (a.S + BQ - 1) / BQ);
  mlstm_tc_kernel<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int BH, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, BH, stream);
    case 64: return launch<T, 64>(a, BH, stream);
    case 128: return launch<T, 128>(a, BH, stream);
    case 256: return launch<T, 256>(a, BH, stream);
    case 512: return launch<T, 512>(a, BH, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// y = mLSTM parallel form of (q, k, v, F, i) as described above.  Strides
// are in elements (batch, head, sequence; the head dim of q, k, v and y is
// contiguous).  q, k, v, F and i are float32; every row of q, k and v
// starts on 16 bytes.  bf16 selects __nv_bfloat16 for y, else float32.
int mlstm_fwd(const void* q, const void* k, const void* v, const void* f,
              const void* ig, void* o, long long q_sb, long long q_sh,
              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
              long long v_sb, long long v_sh, long long v_ss, long long f_sb,
              long long f_sh, long long f_ss, long long i_sb, long long i_sh,
              long long i_ss, long long o_sb, long long o_sh, long long o_ss,
              int B, int H, int S, int hd, int bf16, void* stream) {
  const Args a{static_cast<const float*>(q),  static_cast<const float*>(k),
               static_cast<const float*>(v),  static_cast<const float*>(f),
               static_cast<const float*>(ig), o,
               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
               f_sb, f_sh, f_ss, i_sb, i_sh, i_ss, o_sb, o_sh, o_ss, H, S};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, B * H, hd, s)
              : dispatch<float>(a, B * H, hd, s);
}

const char* mlstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

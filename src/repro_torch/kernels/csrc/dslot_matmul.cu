// Digit-serial MSDF matmul with in-kernel digit extraction and per-tile early
// termination, for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/dslot_matmul.py::_kernel
// (launched by dslot_matmul_pallas).  For each (block_m, block_n) output tile:
//
//   out = [relu]( sum_d 2^(n_bits-1-d) * (P_d * live) @ W )
//
// P_d is bit (n_bits-1-d) of |q| times sign(q), derived here from the
// quantized activations and never stored.  `live` zeroes rows whose budget
// bud[m] <= d.  Plane d runs only while d < min(npl, bnd[tile col]).  After
// every logical K chunk c of plane d, a ReLU tile checks
//   acc + R < 0 everywhere,  R = 2^(n-1-d)*sfx[c] + (2^(n-1-d) - 2^(n-npl))*tot
// and, when it holds, stops all further work and writes zeros.  planes_used
// counts the planes the tile entered.
//
// What bounds it on an H100: the digit planes turn one K-deep product into up
// to n_bits products, so the work is planes_used * 2*bm*bn*K flops per tile
// on f32 CUDA cores (67 TFLOP/s, the H100 SXM data-sheet peak at its 700 W
// power limit), while the bytes are one pass over q
// (1 byte per element at 8 bits), W and the output.  At the shapes of the
// MNIST CNN (N = 8 or 10 columns) the flops are few and the kernel is bound
// by bytes and by latency; at a transformer up-projection it is bound by
// f32 operations.
//
// What the design does about it:
// * One thread block per output tile, in any order; the (d, c) loop runs
//   inside the block and the accumulator stays in registers for the block's
//   whole life (Pallas carried it in VMEM scratch across grid steps).
// * Termination is a real exit: a block-wide AND (__syncthreads_and) of
//   "every element of acc + R is negative", then a uniform break out of both
//   loops, so a dead tile issues no further loads or flops.
// * block_k is the logical chunk that places the termination check and
//   defines sfx; it may be all of K (1152 at the CNN head).  Each logical
//   chunk is staged through shared memory in sub-tiles of KS rows, and the
//   check runs only at the end of a logical chunk.
// * The digit times its plane scale is written to shared memory once per
//   sub-tile, so the inner loop is plain f32 FMAs (digit*scale*w is exact).
//   The termination bound uses __fmul_rn/__fadd_rn so that no FMA contraction
//   changes its rounding against the plain PyTorch version.
// * npl, the per-row budgets and the per-tile plane bounds are read from
//   device memory: a new precision needs no host sync and no rebuild.
// A simple, right kernel first: wgmma, TMA and int8 tensor cores are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 32;  // K rows staged through shared memory per sub-tile

enum QType { Q_U8 = 0, Q_I8 = 1, Q_U16 = 2, Q_I16 = 3, Q_I32 = 4 };
enum WType { W_F32 = 0, W_BF16 = 1 };

__device__ __forceinline__ int load_q(const void* q, int qtype, long long i) {
  switch (qtype) {
    case Q_U8: return static_cast<const uint8_t*>(q)[i];
    case Q_I8: return static_cast<const int8_t*>(q)[i];
    case Q_U16: return static_cast<const uint16_t*>(q)[i];
    case Q_I16: return static_cast<const int16_t*>(q)[i];
    default: return static_cast<const int32_t*>(q)[i];
  }
}

__device__ __forceinline__ float load_w(const void* w, int wtype, long long i) {
  if (wtype == W_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  }
  return static_cast<const float*>(w)[i];
}

// Thread (ty, tx) owns rows ty + a*TR (a < RM) and columns tx + b*TC (b < RN)
// of the tile, with TR = bm / RM and TC = bn / RN; blockDim.x == TR * TC.
template <int RM, int RN>
__global__ void dslot_matmul_kernel(
    const void* __restrict__ q, int qtype, const void* __restrict__ w,
    int wtype, const float* __restrict__ sfx, const float* __restrict__ tot,
    const int* __restrict__ npl_ptr, const int* __restrict__ bnd,
    const int* __restrict__ bud, float* __restrict__ out,
    int* __restrict__ used, int K, int N, int n_bits, int D, int bm, int bn,
    int bk, int relu) {
  extern __shared__ float smem[];
  const int pm = bm + 1;            // padded row: conflict-free stores
  float* plane_s = smem;            // [KS][pm]  digit * 2^(n-1-d), transposed
  float* w_s = smem + KS * pm;      // [KS][bn]

  const int TC = bn / RN;
  const int TR = bm / RM;
  const int tx = threadIdx.x % TC;
  const int ty = threadIdx.x / TC;
  const int nthreads = blockDim.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * bm;
  const int n0 = blockIdx.y * bn;

  float acc[RM][RN];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.0f;

  const int npl = *npl_ptr;
  int limit = min(D, npl);
  if (bnd != nullptr) limit = min(limit, bnd[blockIdx.y]);
  const int n_chunks = K / bk;
  const float tail = ldexpf(1.0f, n_bits - npl);

  int planes = 0;
  bool dead = false;
  for (int d = 0; d < limit && !dead; ++d) {
    ++planes;
    const int shift = n_bits - 1 - d;
    const float scale = ldexpf(1.0f, shift);
    for (int c = 0; c < n_chunks; ++c) {
      const int c_end = (c + 1) * bk;
      for (int k0 = c * bk; k0 < c_end; k0 += KS) {
        const int ks = min(KS, c_end - k0);
        __syncthreads();  // every thread is done with the previous sub-tile
        for (int e = threadIdx.x; e < ks * bm; e += nthreads) {
          const int r = e / ks;
          const int kk = e - r * ks;
          const int v = load_q(q, qtype, (m0 + r) * K + k0 + kk);
          const int bit = (abs(v) >> shift) & 1;
          const int digit = v > 0 ? bit : (v < 0 ? -bit : 0);
          const bool live = bud == nullptr || bud[m0 + r] > d;
          plane_s[kk * pm + r] = live ? static_cast<float>(digit) * scale
                                      : 0.0f;
        }
        for (int e = threadIdx.x; e < ks * bn; e += nthreads) {
          const int kk = e / bn;
          const int col = e - kk * bn;
          w_s[kk * bn + col] =
              load_w(w, wtype, static_cast<long long>(k0 + kk) * N + n0 + col);
        }
        __syncthreads();
        for (int kk = 0; kk < ks; ++kk) {
          float pa[RM], wb[RN];
#pragma unroll
          for (int a = 0; a < RM; ++a) pa[a] = plane_s[kk * pm + ty + a * TR];
#pragma unroll
          for (int b = 0; b < RN; ++b) wb[b] = w_s[kk * bn + tx + b * TC];
#pragma unroll
          for (int a = 0; a < RM; ++a)
#pragma unroll
            for (int b = 0; b < RN; ++b)
              acc[a][b] = fmaf(pa[a], wb[b], acc[a][b]);
        }
      }
      if (relu) {
        bool neg = true;
#pragma unroll
        for (int b = 0; b < RN; ++b) {
          const int col = n0 + tx + b * TC;
          const float rem =
              __fadd_rn(__fmul_rn(scale, sfx[static_cast<long long>(c) * N + col]),
                        __fmul_rn(scale - tail, tot[col]));
#pragma unroll
          for (int a = 0; a < RM; ++a)
            neg = neg && (__fadd_rn(acc[a][b], rem) < 0.0f);
        }
        if (__syncthreads_and(neg)) {
          dead = true;
          break;
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const long long row = m0 + ty + a * TR;
#pragma unroll
    for (int b = 0; b < RN; ++b) {
      float v = acc[a][b];
      if (relu) v = dead ? 0.0f : fmaxf(v, 0.0f);
      out[row * N + n0 + tx + b * TC] = v;
    }
  }
  if (threadIdx.x == 0) used[blockIdx.x * gridDim.y + blockIdx.y] = planes;
}

int largest_divisor(int n) {  // of {8, 4, 2, 1}
  for (int r = 8; r > 1; r /= 2)
    if (n % r == 0) return r;
  return 1;
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int: cudaErrorInvalidValue for shapes the kernel
// does not take, else cudaGetLastError() right after the launch.
int dslot_matmul_launch(const void* q, int qtype, const void* w, int wtype,
                        const void* sfx, const void* tot, const void* npl,
                        const void* bnd, const void* bud, void* out,
                        void* used, int M, int K, int N, int n_bits, int D,
                        int bm, int bn, int bk, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      M % bm != 0 || N % bn != 0 || K % bk != 0 || D < 1 || D > n_bits ||
      n_bits > 30 || qtype < Q_U8 || qtype > Q_I32 || wtype < W_F32 ||
      wtype > W_BF16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rn = largest_divisor(bn);
  const int tc = bn / rn;
  int rm = 0;
  for (int r = 1; r <= 8 && rm == 0; r *= 2)  // fewest rows a thread keeps
    if (bm % r == 0 && (bm / r) * tc <= 256) rm = r;
  for (int r = 8; r >= 1 && rm == 0; r /= 2)
    if (bm % r == 0 && (bm / r) * tc <= 1024) rm = r;
  if (rm == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (bm / rm) * tc;
  const size_t smem = sizeof(float) * KS * static_cast<size_t>(bm + 1 + bn);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(M / bm, N / bn);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

#define DSLOT_LAUNCH(RM_, RN_)                                                 \
  if (rm == RM_ && rn == RN_) {                                                \
    if (smem > 49152) {                                                        \
      cudaError_t err = cudaFuncSetAttribute(                                  \
          dslot_matmul_kernel<RM_, RN_>,                                       \
          cudaFuncAttributeMaxDynamicSharedMemorySize,                         \
          static_cast<int>(smem));                                             \
      if (err != cudaSuccess) return static_cast<int>(err);                    \
    }                                                                          \
    dslot_matmul_kernel<RM_, RN_><<<grid, threads, smem, s>>>(                 \
        q, qtype, w, wtype, static_cast<const float*>(sfx),                    \
        static_cast<const float*>(tot), static_cast<const int*>(npl),          \
        static_cast<const int*>(bnd), static_cast<const int*>(bud),            \
        static_cast<float*>(out), static_cast<int*>(used), K, N, n_bits, D,    \
        bm, bn, bk, relu);                                                     \
    return static_cast<int>(cudaGetLastError());                               \
  }
#define DSLOT_LAUNCH_RN(RM_) \
  DSLOT_LAUNCH(RM_, 1) DSLOT_LAUNCH(RM_, 2) DSLOT_LAUNCH(RM_, 4) DSLOT_LAUNCH(RM_, 8)
  DSLOT_LAUNCH_RN(1)
  DSLOT_LAUNCH_RN(2)
  DSLOT_LAUNCH_RN(4)
  DSLOT_LAUNCH_RN(8)
#undef DSLOT_LAUNCH_RN
#undef DSLOT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dslot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

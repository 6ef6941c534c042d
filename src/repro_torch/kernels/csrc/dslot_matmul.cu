// Digit-serial MSDF matmul with in-kernel digit extraction and per-tile early
// termination, for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/dslot_matmul.py::_kernel
// (launched by dslot_matmul_pallas).  For each logical (block_m, block_n)
// output tile:
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
// The host picks a path from `relu`, `n_bits`, the q type and the tile.
//
// A. Product path (no ReLU, n_bits <= 24).  Nothing can terminate, so the
//    function is one product: out[m, n] = sum_k t[m, k] * w[k, n], with
//    t = sign(q) * (|q| with every bit below plane e cleared) and
//    e = min(D, npl, bnd[tile of n], bud[m]); t is an exact f32 integer.
//    Bound on an H100: bytes (the CNN head moves 1.32 MB for 23.6 MFLOP) and
//    launch latency.  The design: 64 x 16*RN output tiles of 256 threads with
//    f32 FMAs on the CUDA cores, each 64-row round of K loaded with all its
//    loads in flight while the round before computes; when the tiles number
//    fewer than the SMs, K is split across the blocks of one thread-block
//    cluster (the head: 6 slices of 192 -> 96 blocks), whose partial sums
//    are added in slice order through distributed shared memory.  No float
//    atomics: two launches give the same bits.  planes_used is
//    min(D, npl, bnd[j]).
//
// B. Plane path (ReLU tiles, or n_bits > 24).  One thread block owns a
//    logical tile at a time, because the termination vote spans the whole
//    tile.  Bound on an H100: at the MLP's widths, the plane products (up to
//    n_bits products of one K-deep GEMM); at the CNN conv, bytes.  The
//    design:
//    * Digits run on the tensor cores with mma.sync.m16n8k16 bf16.  A digit
//      times its plane scale, +-2^(n-1-d), is exact in bf16.  f32 weights go
//      in as three bf16 parts hi + mid + lo (24 bits of significand: exact),
//      bf16 weights as one; products are exact and the sums are f32 in
//      registers, so no TF32 anywhere.  Each 32-row K sub-chunk is summed
//      into a zeroed temporary and added to the accumulator with a
//      round-to-nearest add: chaining the accumulator through the tensor
//      core, whose adds do not round to nearest, drifts past 1e-5 over
//      K = 1024 and 8 planes.  The mma asm is not volatile and the loops are
//      step-major, so independent products interleave.  Operands reach the
//      mma through ldmatrix (W parts transposed on the way).  mma.sync and
//      not wgmma: the tiles here run from 16 x 8 (the tests' 16 x 5) to
//      128 x 128, and wgmma's 64-row warpgroup tile with its shared-memory
//      descriptors is later work for the 128 x 128 case.
//    * The physical tile is the logical one padded to the mma shape (16 rows,
//      8 columns).  Physical pad rows and columns never vote and are never
//      stored; the logical pad rows and columns the caller added vote as in
//      the reference (their q rows are zero, their tot is zero).
//    * Operands are staged in shared memory once.  A tile of 8 columns whose
//      q rows (contiguous: the tile spans all of K) and W parts fit in
//      RESIDENT_BYTES (the conv: 128 x 8, K = 25) is resident: each block
//      stages W once and walks M tiles, copying the next tile's q (16-byte
//      cp.async where aligned) while the current one computes, and each
//      warp (64 x 8 at the conv) builds its mma fragments from q in
//      registers; where one sub-chunk covers K, the q words, W fragments and
//      suffix sums stay in registers across the planes.  Every other tile
//      streams: one block per tile copies its q rows over all of K once
//      (where they fit beside the ring; the MLP's 128 x 1024 bytes do) and
//      streams W through a 3-stage cp.async ring of KC-row sub-chunks, the
//      next ones in flight while one computes.  A small kernel before the
//      tiles writes W's bf16 parts once per call (or the caller passes the
//      parts dslot_prepare built once), each N tile's columns padded to PN,
//      so that every W row copy is 16-byte cp.async.
//      Where q does not fit, each sub-chunk's q columns ride in its ring
//      stage.  For each (plane, sub-chunk) a streamed block writes the digit
//      tile to shared memory once, so warps that share rows do not extract
//      it again.  The vote runs only at the end of a logical chunk, as in
//      the reference.
//    * The q dtype is a template parameter.  For 8-bit q a word of four
//      elements is decoded at once (__vabsss4, a shift and mask, two
//      __byte_perm and a multiply per bf16 pair); at the conv the tile work
//      is this decoding, so its instruction count is what the design cuts.
//    * The termination bound R uses __fmul_rn/__fadd_rn so that no FMA
//      contraction changes its rounding against the plain PyTorch version;
//      the vote is __syncthreads_and over the logical tile, with no branch
//      per element, then a uniform break, so a dead tile issues no further
//      loads or products.
//
// C. Walk (the tiles that no warp tiling of B takes, whose sums no cluster
//    of E holds: past 1 MB of f32 sums, e.g. 4096 x 136).  B's products and
//    vote, with the tile's sums kept in its own region of `out` between
//    chunks and the tile walked in sub-tiles (walk_kernel).
//
// D. Band (the serving shapes: ReLU, 8-bit signed q, block_n 128, block_m
//    16 to 128, logical chunks of whole 64-row sub-chunks; and the
//    launchers' narrow tiles, below; band_kernel).
//    At these shapes B lost 18-36x to torch.matmul on an H100: 16 x 128
//    tiles gave each warp 6 mma.sync between two barriers, one block a tile
//    re-streamed W's parts for every vote tile and plane (15.1 GB at the
//    hybrid admission's 16 M tiles, against 39.3 MB of bf16 weights), and
//    the parts were rebuilt on every call.  Bound on an H100: the needed
//    bf16 products at admission and prefill (operations), W's bytes at
//    decode.  The design:
//    * One block per N tile and band of up to 128 rows, which holds
//      128 / block_m logical vote tiles (64 rows, where bands of 128 would
//      leave half the SMs idle: the admission shapes of 32-64 N tiles).  Each W sub-chunk is staged once
//      per plane for all of them (W traffic at hybrid admission: ~0.6 GB,
//      mostly L2 hits).  Each vote tile keeps its own sums, vote (an AND over
//      exactly its block_m x 128 elements after each logical chunk) and
//      planes_used; a dead tile writes zeros, and the band stops streaming
//      once every tile is dead or the planes reach the tile's bound.
//    * The products run on wgmma, transposed: wgmma's M is 64 of the tile's
//      columns (one warpgroup each), its N the band's rows, so one
//      instruction shape (m64nNk16, N = 16 to 128) serves decode and
//      admission alike, with no 64-row minimum on the rows.  A = W^T comes
//      from registers: TMA lands each part's 64 x 64 box in shared memory
//      (128-byte swizzle) and ldmatrix.trans reads it into the A fragments.
//      B = the digit tile, written to shared memory by the extraction
//      (K-major, 128-byte swizzle) for every (plane, sub-chunk) and read by
//      wgmma through a descriptor.  The next sub-chunk's digits are written
//      while the current wgmma runs (two digit tiles).
//    * TMA boxes (W parts and the band's q rows) fill a ring of up to 8
//      stages, each with an mbarrier.  One thread refills a stage right
//      after the block's per-sub-chunk barrier has freed it, so no
//      producer warp and no second set of barriers is needed.
//    * Exactness as in B: each 64-row sub-chunk is summed from zero
//      (scale-d 0) and added to the sums with round-to-nearest adds; no
//      TF32.  W's bf16 parts are built once per layer by dslot_prepare
//      (dslot_split_parts): one part where bf16 holds every weight, since a
//      bf16 value's mid and lo parts are zero and adding zero products
//      changes no bit.
//    * A single band computes only the rows that hold real data, rounded up
//      to 16, 32, 64 or 128 (the wrapper passes the unpadded M); the pad
//      rows past them have zero sums, vote with them (so their tile cannot
//      die, as in the reference) and are written as zeros.
//    * Decode bands (16 rows) on fewer N tiles than half the SMs (32 to 64):
//      each N tile's columns split over a 2-block cluster, one warpgroup a
//      block; the two join their votes through distributed shared memory.
//      (On the H100 the split shortened 16-row bands; at 128 rows both
//      halves extract the band's digits, and it lost.)  No element's
//      sum changes with the split, the band size or the rank's share of N,
//      and there are no float atomics: two launches give the same bits.
//    Wide tiles (block_n 256, e.g. DslotConfig(block_n=256)) take the same
//    kernel with each N tile's 256 columns over a 2-block cluster, two
//    warpgroups a block, the halves joining their votes.
//    Narrow tiles (block_n 16, 32 or 64: the port's launchers pass 32 x 32,
//    16 x 16 and 16 x 32 at block_k 16) take it too.  On B they lost
//    20-42x to torch.matmul on an H100: one block of 2 warps a tile, W
//    re-streamed for every row tile and plane, the digits rebuilt in every
//    N tile, a block-wide vote every 16 rows of K.  Here a block holds a
//    band by 128 columns (64 at 16-row bands, no cluster) and so 128 /
//    block_n column tiles; a vote tile is a row tile by a column tile, and
//    since a warp's 16 columns lie in one column tile, it votes in its warp,
//    or in the 2 or 4 warps of one warpgroup joined through a shared word
//    and the warpgroup's named barrier.  Each column tile runs to its own
//    plane bound; the block stops at its per-sub-chunk barrier
//    (__syncthreads_or) once none of its tiles is alive.  Chunks of 16 or
//    32 rows vote inside a sub-chunk: each k step's product goes into one
//    of two sets of sums, from zero, while the other is added (bands of 16
//    or 64 rows, so that both sets fit the registers); each thread takes
//    its part of a chunk's vote right after the chunk's sums, and the
//    tile joins the sub-chunk's 2 or 4 votes at once, 8 bits each, after
//    it (a tile that died mid-sub-chunk adds sums that no output keeps).  N
//    need only be a multiple of block_n (a rank's share of a split layer):
//    TMA fills the columns past N with zeros, and nothing past N is kept.
//    Column tiles of 24, 40, 48 or 56 (seamless's MLP up at 24 columns,
//    which phase 10 shards) with chunks of whole sub-chunks take it as
//    well.  On B they lost 30-44x to torch.matmul on an H100: warp tiles
//    of 8 columns, one block a tile (10944 at 32 x 24), W re-streamed for
//    every row tile, plane and part (12.9 GB from L2 at 32 x 24).  Here a
//    block of two warpgroups holds the whole column tiles that fit in 128
//    columns (120 at 24 and 40, 96 at 48, 112 at 56; the rest of the last
//    warpgroup's products are dropped).  A warp's 16 columns may span two
//    column tiles, but each of its 8-column halves (a thread's columns ca
//    and ca + 8) lies in one: a thread votes for the two tiles apart, a
//    warp ANDs both at once, and lane 0 writes a byte per half; the block
//    barrier that frees a ring stage after each sub-chunk is the tile's
//    join, its OR telling the block whether any vote tile lives on.
//
// E. Cluster (the other tiles that no warp tiling of B takes: more than 16
//    warps of B's tilings, e.g. 1024 x 136 or 16 x 256 with 16-bit q, or a
//    digit tile and ring past one block's shared memory, block_m 2048 and
//    4096 at 8 to 24 columns, and (4, 4) warp tiles whose 3 ring stages
//    overflow it, 448 or 512 x 32 with int32 q; cluster_kernel).  On B the
//    512 x 32 tile lost 10.8x to torch.matmul on an H100: one block of 8
//    warps a tile (4 blocks at (1024, 256) @ (256, 64)) through a 2-stage
//    ring, 48 rounds of 512 x 32 digits each.  walk_kernel lost 25-230x to
//    torch.matmul on an H100 there: one block a tile (4 blocks on 132 SMs
//    for the tall tiles), every sub-chunk staged again for each sub-tile,
//    the sums through `out` once a chunk, no load in flight while a product
//    ran.  A tall tile's sums (557 KB at 1024 x 136) fit no SM, but they fit
//    a cluster.  Bound on an H100: not the operations (under 4 us at these
//    tiles) but a chain of rounds, one a logical chunk: each round's
//    products (a few dependent mma.sync chains a warp), then its vote
//    across the cluster.  The design:
//    * One logical tile spread over a thread-block cluster of up to 16
//      blocks (non-portable; 8 where the card holds no cluster of 16),
//      rows split first (blocks of one row group extract the same digits),
//      then columns.  Each block holds its slice's sums in registers across
//      every plane and chunk.
//    * A slice whose W parts over all of K fit beside its q rows (the tall
//      tiles: K = 256) stages both once and issues no load in its loop;
//      where one warp spans the slice's columns (8-column tiles) each warp
//      builds its rows' digits in registers (B's resident digit path) and
//      the block meets only at the vote, else up to 8 sub-chunks' digits
//      are extracted between two barriers.  Any other slice streams as B
//      does: q rows staged once where they fit, W parts of the slice's
//      columns through the 3-stage cp.async ring, the digit tile written
//      once per (plane, sub-chunk).
//    * The vote: each block ANDs its slice (__syncthreads_and) into a word
//      of its shared memory; every warp reads the cluster's words through
//      distributed shared memory (a lane a block).  Its cluster barrier is
//      split: a block arrives after writing its word and waits only after
//      the next chunk's products, which a dead tile drops (on the H100 the
//      cluster's join was 0.7 us of a 2048 x 8 tile's 3.9 us rounds).  Two
//      words, so one barrier a vote.  Dead tiles stop in every block at once.
//    * mma.sync, not wgmma: the slices are 8 to 144 columns wide with 64 to
//      256 rows; wgmma's N would be the slice's columns (8 to 144, one
//      instruction shape each) and its 64-row M per warpgroup leaves the
//      16-row wide slices, while the rounds are latency chains at under
//      0.1 of the tensor cores' rate.  The 16 x 256 tiles of 8-bit q take
//      the band kernel's transposed wgmma (D).
//    * Exactness as in B: the same products and round-to-nearest adds per
//      32-row sub-chunk, so no sum depends on the cluster's size or split;
//      no float atomics.
// npl, the per-row budgets and the per-tile plane bounds are read from device
// memory in every path: a new precision needs no host sync and no rebuild.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>
#include <cooperative_groups.h>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

enum QType { Q_U8 = 0, Q_I8 = 1, Q_U16 = 2, Q_I16 = 3, Q_I32 = 4 };
enum WType { W_F32 = 0, W_BF16 = 1 };

constexpr int NUM_SMS = 132;          // H100 SXM
constexpr int MAX_SMEM = 232448;      // per block, H100
constexpr int RESIDENT_BYTES = 48 * 1024;

__device__ __forceinline__ float load_w(const void* w, int wtype, long long i) {
  if (wtype == W_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  }
  return static_cast<const float*>(w)[i];
}

// 2^e for -127 < e < 128, built from its exponent field (ldexpf expands to a
// branchy general routine)
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Copy `rows` rows of `row_bytes` bytes from global to shared memory with the
// widest unit the addresses allow: 16-byte or 4-byte cp.async (complete after
// the caller's wait), else plain byte loads (complete at the next barrier).
__device__ void copy_rows(uint8_t* dst, int dst_stride, const uint8_t* src,
                          long long src_stride, int rows, int row_bytes) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(src);
  const long long all = static_cast<long long>(a) | src_stride | row_bytes |
                        dst_stride;
  if ((all & 15) == 0) {
    const int per_row = row_bytes >> 4;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row;
      const int u = e - r * per_row;
      cp_async16(dst + r * dst_stride + u * 16, src + r * src_stride + u * 16);
    }
  } else if ((all & 3) == 0) {
    const int per_row = row_bytes >> 2;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row;
      const int u = e - r * per_row;
      cp_async4(dst + r * dst_stride + u * 4, src + r * src_stride + u * 4);
    }
  } else {
    for (int e = threadIdx.x; e < rows * row_bytes; e += blockDim.x) {
      const int r = e / row_bytes;
      const int u = e - r * row_bytes;
      dst[r * dst_stride + u] = src[r * src_stride + u];
    }
  }
}

// ------------------------------------------------------------ A. product

constexpr int PT_M = 64;    // rows of a product tile
constexpr int PT_KS = 64;   // K rows staged per round
constexpr int PT_THREADS = 256;
constexpr int PT_MAX_SPLITS = 8;  // K slices: one portable cluster

// One round of a product tile's loads into registers, all in flight: q rows
// [m0, m0 + PT_M) and W columns [n0, n0 + 16*RN) of K rows [k0, k0 + PT_KS).
template <int RN, typename QT>
__device__ __forceinline__ void product_round(
    int (&qv)[PT_KS * PT_M / PT_THREADS],
    float (&wv)[PT_KS * 16 * RN / PT_THREADS], const QT* __restrict__ q,
    const void* __restrict__ w, int wtype, long long m0, int n0, int k0,
    int k_hi, int M, int K, int N) {
  constexpr int TN = 16 * RN;
#pragma unroll
  for (int i = 0; i < PT_KS * PT_M / PT_THREADS; ++i) {
    const int e = threadIdx.x + i * PT_THREADS;
    const long long m = m0 + e / PT_KS;
    const int k = k0 + e % PT_KS;
    qv[i] = (m < M && k < k_hi) ? static_cast<int>(q[m * K + k]) : 0;
  }
#pragma unroll
  for (int i = 0; i < PT_KS * TN / PT_THREADS; ++i) {
    const int e = threadIdx.x + i * PT_THREADS;
    const int k = k0 + e / TN;
    const int col = n0 + e % TN;
    wv[i] = (k < k_hi && col < N)
                ? load_w(w, wtype, static_cast<long long>(k) * N + col)
                : 0.0f;
  }
}

// Thread (ty, tx) owns rows ty + 16a (a < 4) and columns tx + 16b (b < RN) of
// a 64 x 16*RN tile.  Block z sums K rows [z*k_slice, (z+1)*k_slice); the
// gridDim.z blocks of a tile form one thread-block cluster, and their partial
// sums are added through distributed shared memory in slice order, each
// block adding a share of the tile's elements.  When every column bound of
// the tile is 0 or at least min(D, npl) ("uniform", the case of the
// prepared MSR bounds), t depends on the row alone and is staged as f32, so
// the inner loop is plain FMAs; otherwise q is staged and each (row, column)
// applies its own mask.  Each round's loads are issued before the previous
// round computes.  A launch covers at most 65535 column tiles (grid.y's
// limit), so a wider product takes several launches of the SLAB variant,
// whose column tile is y0 + blockIdx.y (the other variant's code is the
// one that ran before slabs).
template <int RN, typename QT, bool SLAB>
__global__ void __launch_bounds__(PT_THREADS) product_kernel(
    const QT* __restrict__ q, const void* __restrict__ w, int wtype,
    const int* __restrict__ npl_ptr, const int* __restrict__ bnd,
    const int* __restrict__ bud, float* __restrict__ out,
    int* __restrict__ used, int M, int K, int N, int n_bits, int D, int bm,
    int bn, int k_slice, int y0) {
  constexpr int TN = 16 * RN;
  constexpr int QL = PT_KS * PT_M / PT_THREADS;  // q loads per thread
  constexpr int WL = PT_KS * TN / PT_THREADS;    // W loads per thread
  static_assert(PT_KS * (PT_M + 1) >= PT_M * TN, "partial sums fit q_s");
  __shared__ int q_s[PT_KS][PT_M + 1];  // t as f32 bits, or q; then sums
  __shared__ float w_s[PT_KS][TN];
  __shared__ unsigned keep_s[PT_M];     // bits of |q| kept, by row

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * PT_M;
  const int n0 = (SLAB ? blockIdx.y + y0 : blockIdx.y) * TN;
  const int k_lo = blockIdx.z * k_slice;
  const int k_hi = min(K, k_lo + k_slice);
  const int npl = *npl_ptr;
  const int e_max = min(D, npl);
  auto keep_bits = [&](int e) {  // planes 0 .. e-1 of an n_bits magnitude
    return e <= 0 ? 0u : ~((1u << (n_bits - e)) - 1u);
  };

  int qv[QL];
  float wv[WL];
  product_round<RN, QT>(qv, wv, q, w, wtype, m0, n0, k_lo, k_hi, M, K, N);

  if (threadIdx.x < PT_M) {
    const long long m = m0 + threadIdx.x;
    int e_row = 0;
    if (m < M) e_row = bud == nullptr ? e_max : min(e_max, bud[m]);
    keep_s[threadIdx.x] = keep_bits(e_row);
  }
  int b_col[RN];
  bool uniform_mine = true;
#pragma unroll
  for (int b = 0; b < RN; ++b) {
    const int col = n0 + tx + 16 * b;
    b_col[b] = col < N ? bnd[col / bn] : 0;
    uniform_mine = uniform_mine && (b_col[b] <= 0 || b_col[b] >= e_max);
  }
  const bool uniform = __syncthreads_and(uniform_mine) != 0;
  unsigned keep[4][RN];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const unsigned row_keep = keep_s[ty + 16 * a];
#pragma unroll
    for (int b = 0; b < RN; ++b)
      keep[a][b] = b_col[b] >= e_max ? row_keep
                                     : row_keep & keep_bits(b_col[b]);
  }

  float acc[4][RN];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += PT_KS) {
    __syncthreads();  // every thread is done with the previous round
#pragma unroll
    for (int i = 0; i < QL; ++i) {
      const int e = threadIdx.x + i * PT_THREADS;
      const int r = e / PT_KS;
      int v = qv[i];
      if (uniform) {
        const unsigned mag = static_cast<unsigned>(v < 0 ? -v : v);
        const float t = static_cast<float>(mag & keep_s[r]);
        v = __float_as_int(v < 0 ? -t : t);
      }
      q_s[e % PT_KS][r] = v;
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int e = threadIdx.x + i * PT_THREADS;
      w_s[e / TN][e % TN] = wv[i];
    }
    if (k0 + PT_KS < k_hi)  // the next round's loads, in flight meanwhile
      product_round<RN, QT>(qv, wv, q, w, wtype, m0, n0, k0 + PT_KS, k_hi, M,
                            K, N);
    __syncthreads();
    if (uniform) {
#pragma unroll 8
      for (int kk = 0; kk < PT_KS; ++kk) {
        float wb[RN];
#pragma unroll
        for (int b = 0; b < RN; ++b) wb[b] = w_s[kk][tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float t = __int_as_float(q_s[kk][ty + 16 * a]);
#pragma unroll
          for (int b = 0; b < RN; ++b) acc[a][b] = fmaf(t, wb[b], acc[a][b]);
        }
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < PT_KS; ++kk) {
        float wb[RN];
#pragma unroll
        for (int b = 0; b < RN; ++b) wb[b] = w_s[kk][tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int v = q_s[kk][ty + 16 * a];
          const unsigned mag = static_cast<unsigned>(v < 0 ? -v : v);
#pragma unroll
          for (int b = 0; b < RN; ++b) {
            const float t = static_cast<float>(mag & keep[a][b]);
            acc[a][b] = fmaf(v < 0 ? -t : t, wb[b], acc[a][b]);
          }
        }
      }
    }
  }
  // uniform: a column of bound 0 was summed at the row's depth
#pragma unroll
  for (int b = 0; b < RN; ++b)
    if (b_col[b] <= 0)
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][b] = 0.0f;

  if (blockIdx.x == 0 && (SLAB ? blockIdx.y + y0 : blockIdx.y) == 0 &&
      blockIdx.z == 0) {
    const int Nt = N / bn;
    for (int e = threadIdx.x; e < (M / bm) * Nt; e += PT_THREADS)
      used[e] = min(e_max, bnd[e % Nt]);
  }
  if (gridDim.z == 1) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const long long m = m0 + ty + 16 * a;
#pragma unroll
      for (int b = 0; b < RN; ++b) {
        const int col = n0 + tx + 16 * b;
        if (m < M && col < N) out[m * N + col] = acc[a][b];
      }
    }
    return;
  }
  // the cluster's sum, slice by slice in order
  float* part = reinterpret_cast<float*>(&q_s[0][0]);  // [PT_M][TN]
  __syncthreads();  // every thread is done with q_s
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b)
      part[(ty + 16 * a) * TN + tx + 16 * b] = acc[a][b];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = gridDim.z;
  const int share = (PT_M * TN + splits - 1) / splits;
  const int e0 = static_cast<int>(cluster.block_rank()) * share;
  for (int e = e0 + threadIdx.x; e < min(e0 + share, PT_M * TN);
       e += PT_THREADS) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) {
      const float v = *cluster.map_shared_rank(part + e, z);
      s = z == 0 ? v : s + v;
    }
    const long long m = m0 + e / TN;
    const int col = n0 + e % TN;
    if (m < M && col < N) out[m * N + col] = s;
  }
  cluster.sync();  // no block leaves while its partial sums are read
}

// ------------------------------------------------------------ B. planes

constexpr int KC = 32;        // K rows of a sub-chunk
constexpr int NSTAGE = 3;     // cp.async ring depth
constexpr int AS = KC + 8;    // bf16 per digit-tile row (80 B: no conflicts)

// The mma asm is not volatile: it only reads and writes registers, and the
// compiler may then interleave independent accumulators instead of waiting
// out each product's latency in program order.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a @ b, from a zero accumulator
__device__ __forceinline__ void mma_bf16_z(float (&c)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// bf16 bits of digit * 2^shift (0 or +-2^shift) for one q element; `e_bits`
// is the exponent field of 2^shift.
template <typename QT>
__device__ __forceinline__ uint32_t digit_bits(QT v, int shift,
                                               uint32_t e_bits, bool live) {
  const int x = static_cast<int>(v);
  const uint32_t mag = static_cast<uint32_t>(x < 0 ? -x : x);
  const uint32_t bit = ((mag >> shift) & 1u) & static_cast<uint32_t>(live);
  return (0u - bit) & (e_bits | (static_cast<uint32_t>(x < 0) << 15));
}

// Four 1-byte q elements at src as one word (src need not be aligned: the
// word is assembled from the two aligned words around it); elements from
// `valid` on are zero.
template <typename QT>
__device__ __forceinline__ uint32_t load_word4(const QT* src, int valid) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(src);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
  // offset from src itself, so the compiler keeps its shared-memory space
  const uint32_t* wd = reinterpret_cast<const uint32_t*>(p - mis);
  uint32_t x = __funnelshift_r(wd[0], wd[1], static_cast<uint32_t>(mis) * 8);
  if (valid < 4) x &= valid <= 0 ? 0u : 0xffffffffu >> (8 * (4 - valid));
  return x;
}

// Magnitudes and sign flags (0x01 per negative byte) of four 1-byte q.
template <typename QT>
__device__ __forceinline__ void mag_neg4(uint32_t x, uint32_t& mag,
                                         uint32_t& neg) {
  if constexpr (std::is_signed<QT>::value) {
    mag = __vabsss4(x);
    neg = (x >> 7) & 0x01010101u;
  } else {
    mag = x;
    neg = 0u;
  }
}

// Digits of four 1-byte q (magnitudes, sign flags) as two bf16 pairs: lo
// holds elements 0 and 1, hi 2 and 3.  Per byte lane: the bit, then the
// bf16 pattern of +-2^shift.
__device__ __forceinline__ void decode4(uint32_t mag, uint32_t neg, int shift,
                                        uint32_t e_bits, bool live,
                                        uint32_t& lo, uint32_t& hi) {
  const uint32_t bits = live ? (mag >> shift) & 0x01010101u : 0u;
  const uint32_t n = neg & bits;
  lo = __byte_perm(bits, 0u, 0x4140) * e_bits |
       __byte_perm(n, 0u, 0x4140) << 15;
  hi = __byte_perm(bits, 0u, 0x4342) * e_bits |
       __byte_perm(n, 0u, 0x4342) << 15;
}

// Digits of the four q elements at src as two bf16 pairs (lo: elements 0
// and 1, hi: 2 and 3); elements from `valid` on are zero.  1-byte q with
// fewer than 9 bits decodes a word at once.
template <typename QT>
__device__ __forceinline__ void digits4(const QT* src, int shift,
                                        uint32_t e_bits, bool live, int valid,
                                        uint32_t& lo, uint32_t& hi) {
  if constexpr (sizeof(QT) == 1) {
    if (shift < 8) {
      uint32_t mag, neg;
      mag_neg4<QT>(load_word4(src, valid), mag, neg);
      decode4(mag, neg, shift, e_bits, live, lo, hi);
      return;
    }
  }
  uint32_t h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    h[j] = digit_bits(src[j], shift, e_bits, live && j < valid);
  lo = h[0] | (h[1] << 16);
  hi = h[2] | (h[3] << 16);
}

// Digit plane d of KC K columns of q (rows of stride q_row elements) into
// the bf16 tile a_s [PM][AS], once for the whole block; columns from v on
// are zero.
template <typename QT>
__device__ __forceinline__ void extract_digits(__nv_bfloat16* a_s,
                                               const QT* q_s, int q_row,
                                               const int* rbud_s, int PM,
                                               int shift, int d, int v) {
  const uint32_t e_bits = static_cast<uint32_t>(127 + shift) << 7;
  for (int e = threadIdx.x; e < PM * (KC / 4); e += blockDim.x) {
    const int r = e / (KC / 4);
    const int k = 4 * (e % (KC / 4));
    uint32_t lo, hi;
    digits4(q_s + r * q_row + k, shift, e_bits, rbud_s[r] > d, v - k, lo, hi);
    *reinterpret_cast<uint2*>(a_s + r * AS + k) = make_uint2(lo, hi);
  }
}

// The W-part fragments of a sub-chunk (two mma steps of 16 K rows) for the
// warp's columns.  Parts are k-major [part][k][p_row], read transposed by
// ldmatrix.
template <int NI>
__device__ __forceinline__ void load_b(uint32_t (&b)[2][3][NI][2],
                                       const __nv_bfloat16* p_s, int p_row,
                                       int p_part, int parts, int wn0,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (p >= parts) break;
      const __nv_bfloat16* base =
          p_s + p * p_part + (ks * 16 + (lane & 15)) * p_row + wn0;
      if constexpr (NI == 1) {
        uint32_t r[2];
        ldsm_x2_t(r, base);
        b[ks][p][0][0] = r[0];
        b[ks][p][0][1] = r[1];
      } else {
#pragma unroll
        for (int ni = 0; ni < NI; ni += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, base + ni * 8 + (lane >> 4) * 8);
          b[ks][p][ni][0] = r[0];
          b[ks][p][ni][1] = r[1];
          b[ks][p][ni + 1][0] = r[2];
          b[ks][p][ni + 1][1] = r[3];
        }
      }
    }
}

// t[g][ni] = a[g] @ W parts for G row fragments and NI column fragments,
// over the two 16-row steps of a sub-chunk (a[g][0]: K rows 0-15, a[g][1]:
// 16-31), lo part first.  The loops are step-major, so consecutive mma are
// independent.
template <int G, int NI>
__device__ __forceinline__ void mma_steps(float (&t)[G][NI][4],
                                          const uint32_t (&a)[G][2][4],
                                          const uint32_t (&b)[2][3][NI][2],
                                          int parts) {
  if (parts == 3) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        mma_bf16_z(t[g][ni], a[g][0], b[0][2][ni][0], b[0][2][ni][1]);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        mma_bf16(t[g][ni], a[g][0], b[0][1][ni][0], b[0][1][ni][1]);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        mma_bf16(t[g][ni], a[g][0], b[0][0][ni][0], b[0][0][ni][1]);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        mma_bf16(t[g][ni], a[g][1], b[1][2][ni][0], b[1][2][ni][1]);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        mma_bf16(t[g][ni], a[g][1], b[1][1][ni][0], b[1][1][ni][1]);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        mma_bf16_z(t[g][ni], a[g][0], b[0][0][ni][0], b[0][0][ni][1]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      mma_bf16(t[g][ni], a[g][1], b[1][0][ni][0], b[1][0][ni][1]);
}

// acc += t with one round-to-nearest add per element: each sub-chunk's
// products are summed from zero and then added here, because the tensor
// core's own accumulation does not round to nearest, and chained over all
// of K and the planes it drifts past 1e-5.
template <int NI>
__device__ __forceinline__ void flush(float (&acc)[NI][4],
                                      const float (&t)[NI][4]) {
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = __fadd_rn(acc[ni][e], t[ni][e]);
}

// A sub-chunk with the digits read from the block's digit tile a_s.
template <int MI, int NI>
__device__ __forceinline__ void mma_item(float (&acc)[MI][NI][4],
                                         const __nv_bfloat16* a_s,
                                         const __nv_bfloat16* p_s, int p_row,
                                         int p_part, int parts, int wm0,
                                         int wn0, int lane) {
  // row fragments per mma_steps call: all of the warp's rows when its
  // accumulators are few (MI * NI products interleave), else one
  constexpr int G = MI * NI <= 4 ? MI : 1;
  uint32_t b[2][3][NI][2];
  load_b<NI>(b, p_s, p_row, p_part, parts, wn0, lane);
#pragma unroll
  for (int m0 = 0; m0 < MI; m0 += G) {
    uint32_t a[G][2][4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const __nv_bfloat16* row =
          a_s + (wm0 + (m0 + g) * 16 + (lane & 15)) * AS + (lane >> 4) * 8;
      ldsm_x4(a[g][0], row);
      ldsm_x4(a[g][1], row + 16);
    }
    float t[G][NI][4];
    mma_steps<G, NI>(t, a, b, parts);
#pragma unroll
    for (int g = 0; g < G; ++g) flush<NI>(acc[m0 + g], t[g]);
  }
}

// A sub-chunk with each warp building its own digit fragments from q in
// registers (a warp that spans all columns shares its rows with no other
// warp).  Lane (g, t4) takes the four consecutive K columns 4*t4 .. 4*t4+3
// of each 16-column step; the W parts were stored with the matching
// permutation of their rows (perm_k).
template <int MI, int NI, typename QT>
__device__ __forceinline__ void mma_item_reg(
    float (&acc)[MI][NI][4], const QT* q_s, int q_row, const int* rbud_s,
    const __nv_bfloat16* p_s, int p_row, int p_part, int parts, int shift,
    int d, int v, int wm0, int wn0, int lane) {
  // row fragments per mma_steps call: all of the warp's rows when its
  // accumulators are few (MI * NI products interleave), else one
  constexpr int G = MI * NI <= 4 ? MI : 1;
  const int k4 = 4 * (lane & 3);
  const uint32_t e_bits = static_cast<uint32_t>(127 + shift) << 7;
  uint32_t b[2][3][NI][2];
  load_b<NI>(b, p_s, p_row, p_part, parts, wn0, lane);
#pragma unroll
  for (int m0 = 0; m0 < MI; m0 += G) {
    uint32_t a[G][2][4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r0 = wm0 + (m0 + g) * 16 + (lane >> 2);
      const bool l0 = rbud_s[r0] > d;
      const bool l1 = rbud_s[r0 + 8] > d;
      const QT* s0 = q_s + r0 * q_row + k4;
      const QT* s1 = s0 + 8 * q_row;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int valid = v - 16 * ks - k4;
        digits4(s0 + 16 * ks, shift, e_bits, l0, valid, a[g][ks][0],
                a[g][ks][2]);
        digits4(s1 + 16 * ks, shift, e_bits, l1, valid, a[g][ks][1],
                a[g][ks][3]);
      }
    }
    float t[G][NI][4];
    mma_steps<G, NI>(t, a, b, parts);
#pragma unroll
    for (int g = 0; g < G; ++g) flush<NI>(acc[m0 + g], t[g]);
  }
}

// Row of K column k (within a 16-column mma step) in the register path's
// W-part layout: column 4t + 2h + e sits at row 8h + 2t + e, where the mma
// fragment of lane t expects it.
__device__ __forceinline__ int perm_k(int k) {
  return (k & ~15) | (((k >> 1) & 1) << 3) | (((k >> 2) & 3) << 1) | (k & 1);
}

// Write the bf16 parts of x: hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid); one part for bf16 weights.
__device__ __forceinline__ void split_w(__nv_bfloat16* dst, int p_part,
                                        float x, int parts) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  dst[0] = hi;
  if (parts == 3) {
    const float r1 = x - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    dst[p_part] = mid;
    dst[2 * p_part] = __float2bfloat16_rn(r1 - __bfloat162float(mid));
  }
}

// The bf16 parts of W for tiles that stream it, laid out [part][K][N tile]
// [PN]: each N tile's bn columns padded with zeros to PN, so that a row of a
// tile is 16-byte aligned and is copied with 16-byte cp.async whatever bn
// is.  n_parts 3 gives hi = bf16(w), mid = bf16(w - hi), lo =
// bf16(w - hi - mid); n_parts 1 gives hi alone, read from W's own type (f32
// or bf16) in the same pass.  Replaces no TPU kernel: the Pallas kernel
// multiplies W as it is stored.  Bound on an H100: bytes (W read once, the
// parts written once; 0.030 ms for an olmo layer's f32 W to one part).
// The design: where PN == bn a row of the layout is a row of W, so the
// layout is W's flat order and each thread converts 8 consecutive weights
// (two float4 loads of f32, one uint4 of bf16, a uint4 store to each part)
// in a grid-stride loop over a grid of a few waves; any other case
// (bn not a multiple of 8, W or the parts not 16-byte aligned) walks the
// layout element by element, its (k, tile, column) carried from one step to
// the next without a division.
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_BLOCKS = 32 * NUM_SMS;  // 4 waves of 8 blocks an SM

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x's 8 weights split into parts at wp[i .. i + 8), + n, + 2n (i a multiple
// of 8, n the elements of one part).
__device__ __forceinline__ void split8(const float (&x)[8], int n_parts,
                                       __nv_bfloat16* __restrict__ wp,
                                       long long i, long long n) {
  float hi[8];
  uint32_t h[4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    h[e / 2] = bf16_pair(x[e], x[e + 1]);
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
        &h[e / 2]);
    hi[e] = __low2float(v);
    hi[e + 1] = __high2float(v);
  }
  *reinterpret_cast<uint4*>(wp + i) = make_uint4(h[0], h[1], h[2], h[3]);
  if (n_parts != 3) return;
  float r1[8], mid[8];
  uint32_t m[4], l[4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    r1[e] = __fsub_rn(x[e], hi[e]);
    r1[e + 1] = __fsub_rn(x[e + 1], hi[e + 1]);
    m[e / 2] = bf16_pair(r1[e], r1[e + 1]);
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
        &m[e / 2]);
    mid[e] = __low2float(v);
    mid[e + 1] = __high2float(v);
  }
#pragma unroll
  for (int e = 0; e < 8; e += 2)
    l[e / 2] = bf16_pair(__fsub_rn(r1[e], mid[e]),
                         __fsub_rn(r1[e + 1], mid[e + 1]));
  *reinterpret_cast<uint4*>(wp + n + i) = make_uint4(m[0], m[1], m[2], m[3]);
  *reinterpret_cast<uint4*>(wp + 2 * n + i) =
      make_uint4(l[0], l[1], l[2], l[3]);
}

__global__ void __launch_bounds__(SPLIT_THREADS) split_parts_kernel(
    const void* __restrict__ w, int wtype, int n_parts,
    __nv_bfloat16* __restrict__ wp, int K, int N, int bn, int PN, int vec) {
  const int Nt = N / bn;
  const long long n = static_cast<long long>(K) * Nt * PN;  // a part
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  if (vec) {  // PN == bn: the layout is W's flat order, 8 weights a step
    for (long long v = first; v < n / 8; v += step) {
      float x[8];
      if (wtype == W_F32) {
        const float4 a = static_cast<const float4*>(w)[2 * v];
        const float4 b = static_cast<const float4*>(w)[2 * v + 1];
        x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
        x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
      } else {
        const uint4 u = static_cast<const uint4*>(w)[v];
        const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[2 * e] = __uint_as_float(words[e] << 16);
          x[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
        }
      }
      split8(x, n_parts, wp, 8 * v, n);
    }
    return;
  }
  // element i of the layout is (k, j, c): row k, N tile j, column c; the
  // grid's step, decomposed once, carries each from one element to the next
  const long long row = static_cast<long long>(Nt) * PN;
  int k = static_cast<int>(first / row);
  int j = static_cast<int>(first % row / PN);
  int c = static_cast<int>(first % row % PN);
  const int sk = static_cast<int>(step / row);
  const int sj = static_cast<int>(step % row / PN);
  const int sc = static_cast<int>(step % row % PN);
  for (long long i = first; i < n; i += step) {
    const float x = c < bn
        ? load_w(w, wtype, static_cast<long long>(k) * N +
                               static_cast<long long>(j) * bn + c)
        : 0.0f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    wp[i] = hi;
    if (n_parts == 3) {
      const float r1 = __fsub_rn(x, __bfloat162float(hi));
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      wp[n + i] = mid;
      wp[2 * n + i] =
          __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    }
    c += sc;
    j += sj;
    k += sk;
    if (c >= PN) c -= PN, ++j;
    if (j >= Nt) j -= Nt, ++k;
  }
}

// One launch of split_parts_kernel: the vector path where PN == bn and W
// and the parts are 16-byte aligned, else the general path.
cudaError_t launch_split(const void* w, int wtype, int n_parts,
                         __nv_bfloat16* wp, int K, int N, int bn, int PN,
                         cudaStream_t s) {
  const int vec = PN == bn &&
                  ((reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(wp)) & 15) == 0;
  const long long units =
      static_cast<long long>(K) * (N / bn) * PN / (vec ? 8 : 1);
  const long long want = (units + SPLIT_THREADS - 1) / SPLIT_THREADS;
  const int blocks = static_cast<int>(want < SPLIT_BLOCKS ? want
                                                          : SPLIT_BLOCKS);
  split_parts_kernel<<<blocks, SPLIT_THREADS, 0, s>>>(w, wtype, n_parts, wp,
                                                      K, N, bn, PN, vec);
  return cudaGetLastError();
}

struct PlaneGeom {
  int PM, PN;     // physical tile: block_m, block_n padded to 16 and 8
  int WN;         // warps across the columns
  int resident;   // 1: 8 columns, every W part staged once, digits in
                  // registers
  int q_once;     // streamed: the tile's q rows over all of K staged once
  int q_stride;   // streamed: staged q row stride, bytes
  int q_bytes;    // resident: one buffer of a tile's q rows, bytes
  int off_a, off_p, off_q;  // shared-memory offsets, bytes
  int p_part;     // bf16 elements per W part
  int smem;       // dynamic shared memory, bytes
  int nstage;     // ring stages (plane_kernel's NS): NSTAGE, or 2 for a
                  // tall tile whose NSTAGE stages overflow MAX_SMEM
  int Nt;         // N tiles: N / bn
  int y0;         // the first N tile of this launch (grid.y holds 65535)
};

template <int MI, int NI>
__device__ __forceinline__ void zero_tile(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
}

// Chunk c's suffix sums for the thread's columns.
template <int NI>
__device__ __forceinline__ void load_sf(float (&sf)[NI][2],
                                        const float* __restrict__ sfx, int c,
                                        int N, int n0, int wn0, int t4,
                                        int bn) {
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = wn0 + ni * 8 + 2 * t4 + j;
      sf[ni][j] =
          col < bn ? sfx[static_cast<long long>(c) * N + n0 + col] : 0.0f;
    }
}

// The thread's part of the termination vote: "every acc + R of its
// elements is negative", R = scale * sf + (scale - tail) * tot.  Physical
// pad rows and columns do not vote.  No branches: every element is tested.
template <int MI, int NI>
__device__ __forceinline__ int tile_votes(const float (&acc)[MI][NI][4],
                                          const float (&sf)[NI][2],
                                          const float (&tot_c)[NI][2],
                                          float scale, float tail, int wm0,
                                          int wn0, int g, int t4, int bm,
                                          int bn) {
  int ok = 1;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int pad_col = wn0 + ni * 8 + 2 * t4 + j >= bn;
      const float rem = __fadd_rn(__fmul_rn(scale, sf[ni][j]),
                                  __fmul_rn(scale - tail, tot_c[ni][j]));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pad_row = wm0 + mi * 16 + g + 8 * h >= bm;
          ok &= pad_col | pad_row |
                static_cast<int>(__fadd_rn(acc[mi][ni][2 * h + j], rem) < 0.0f);
        }
    }
  return ok;
}

// The termination vote of the logical tile: tile_votes ANDed over the block.
template <int MI, int NI>
__device__ __forceinline__ bool tile_dead(const float (&acc)[MI][NI][4],
                                          const float (&sf)[NI][2],
                                          const float (&tot_c)[NI][2],
                                          float scale, float tail, int wm0,
                                          int wn0, int g, int t4, int bm,
                                          int bn) {
  return __syncthreads_and(tile_votes<MI, NI>(acc, sf, tot_c, scale, tail,
                                              wm0, wn0, g, t4, bm, bn)) != 0;
}

// Write the logical part of a tile ([relu], zeros when it terminated) and
// its planes_used.
template <int MI, int NI>
__device__ __forceinline__ void store_tile(const float (&acc)[MI][NI][4],
                                           float* __restrict__ out,
                                           int* __restrict__ used,
                                           long long m0, int n0, int N,
                                           int used_at, int planes, bool dead,
                                           int relu, int wm0, int wn0, int g,
                                           int t4, int bm, int bn) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm0 + mi * 16 + g + 8 * (e >> 1);
        const int col = wn0 + ni * 8 + 2 * t4 + (e & 1);
        if (row < bm && col < bn) {
          float v = acc[mi][ni][e];
          if (relu) v = dead ? 0.0f : fmaxf(v, 0.0f);
          out[(m0 + row) * N + n0 + col] = v;
        }
      }
  if (threadIdx.x == 0) used[used_at] = planes;
}

// Shared memory.  Streamed: row budgets [PM] i32 | the digit tile [PM][AS]
// bf16 | q_once: the tile's q rows over all of K, copied once | NSTAGE ring
// stages, each (unless q_once) the q rows of a KC-column sub-chunk, then the
// W parts of its KC rows, copied from `wp` (the bf16 parts
// [part][K][N tile][PN] written once per call by split_parts_kernel).
// Resident (8 columns, digits in registers): row budgets | W
// parts of all of K laid out per sub-chunk, rows permuted by perm_k | two
// buffers of a tile's q rows as copied (the next tile's rows land while this
// one computes).  Warp w owns rows (w / WN)*16*MI + [0, 16*MI) and columns
// (w % WN)*8*NI + [0, 8*NI) of the physical tile.  A streamed block computes
// one tile; a resident block computes M tiles blockIdx.x, + gridDim.x, ...
// of N tile nt, with W staged once.  More than 65535 N tiles (grid.y's
// limit) take several launches, as the product path's do: in the SLAB
// variant N tile nt = geo.y0 + blockIdx.y of geo.Nt, otherwise blockIdx.y
// of gridDim.y, the code of the warp tiles that ran before slabs.  Only the
// (1, 1) and (4, 1) warp tiles run resident; (2, 1), (8, 1) and (16, 1) are
// for streamed tiles that (1, 1), (2, 2) and (4, 4) cannot cover in 16 or 8
// warps (128 x 24, 512 x 8, 1024 x 24).  NS ring stages: NSTAGE, or 2 for a
// tile whose NSTAGE stages overflow the shared memory (plane_geometry).
template <int MI, int NI, typename QT, int NS, bool SLAB>
__global__ void __launch_bounds__(
    MI == 1 ? 512 : (NI == 1 ? (MI == 4 ? 128 : 512) : 256))
    plane_kernel(
    const QT* __restrict__ q, const void* __restrict__ w, int wtype,
    const __nv_bfloat16* __restrict__ wp, const float* __restrict__ sfx,
    const float* __restrict__ tot, const int* __restrict__ npl_ptr,
    const int* __restrict__ bnd, const int* __restrict__ bud,
    float* __restrict__ out, int* __restrict__ used, int Mt, int K, int N,
    int n_bits, int D, int bm, int bn, int bk, int relu, PlaneGeom geo) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* rbud_s = reinterpret_cast<int*>(smem);
  uint8_t* q_area = smem + geo.off_q;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm0 = (warp / geo.WN) * MI * 16;
  const int wn0 = (warp % geo.WN) * NI * 8;
  // N tiles and this block's N tile, as expressions: where !SLAB they are
  // gridDim.y and blockIdx.y themselves, in the types they have
#define DSLOT_NT (SLAB ? static_cast<unsigned>(geo.Nt) : gridDim.y)
#define DSLOT_TILE (SLAB ? blockIdx.y + geo.y0 : blockIdx.y)
  const int n0 = DSLOT_TILE * bn;
  const int parts = wtype == W_F32 ? 3 : 1;
  const int PM = geo.PM;
  const int PN = geo.PN;
  const int p_row = PN + 8;
  const int Kt = K / bk;
  const int S = (bk + KC - 1) / KC;  // sub-chunks per logical chunk
  const int T = Kt * S;

  const int npl = *npl_ptr;
  const int limit = min(min(D, npl), bnd[DSLOT_TILE]);
  const float tail = pow2(n_bits - npl);

  float tot_c[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = wn0 + ni * 8 + 2 * t4 + j;
      tot_c[ni][j] = col < bn ? tot[n0 + col] : 0.0f;
    }
  float sf[NI][2];
  float acc[MI][NI][4];
  auto fill_budgets = [&](long long m0) {  // pad rows: never live
    for (int r = threadIdx.x; r < PM; r += blockDim.x)
      rbud_s[r] = r >= bm ? 0 : (bud == nullptr ? D : bud[m0 + r]);
  };

  if constexpr (!(MI == 4 && NI == 1)) if (!geo.resident) {
    // ---- streamed: one tile, W (and q unless q_once) through the ring
    __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem + geo.off_a);
    const long long m0 = static_cast<long long>(blockIdx.x) * bm;
    const QT* q_tile = q + m0 * K;
    const int q_stage = geo.q_once ? 0 : PM * geo.q_stride;
    const int stage = q_stage + parts * geo.p_part * 2;
    uint8_t* ring = q_area + (geo.q_once ? PM * geo.q_stride : 0);
    const int total = limit * T;  // (plane, chunk, sub-chunk) items
    auto issue = [&](int item) {
      const int r = item % T;
      const int c = r / S;
      const int s = r - c * S;
      const int k0 = c * bk + s * KC;
      const int v = min(KC, bk - s * KC);
      uint8_t* st = ring + (item % NS) * stage;
      if (!geo.q_once)
        copy_rows(st, geo.q_stride,
                  reinterpret_cast<const uint8_t*>(q_tile + k0),
                  static_cast<long long>(K) * sizeof(QT), bm,
                  v * static_cast<int>(sizeof(QT)));
      for (int p = 0; p < parts; ++p)
        copy_rows(st + q_stage + p * geo.p_part * 2, p_row * 2,
                  reinterpret_cast<const uint8_t*>(
                      wp + ((p * static_cast<long long>(K) + k0) * DSLOT_NT +
                            DSLOT_TILE) * PN),
                  static_cast<long long>(DSLOT_NT) * PN * 2, v, PN * 2);
    };
    fill_budgets(m0);
    zero_tile<MI, NI>(acc);
    // zero the ring once: W rows past a chunk's end are multiplied by zero
    // digits and must be finite
    uint4* z = reinterpret_cast<uint4*>(ring);
    for (int e = threadIdx.x; e < NS * stage / 16; e += blockDim.x)
      z[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    if (geo.q_once && total > 0)  // lands with the first item
      copy_rows(q_area, geo.q_stride, reinterpret_cast<const uint8_t*>(q_tile),
                static_cast<long long>(K) * sizeof(QT), bm,
                K * static_cast<int>(sizeof(QT)));
    for (int i = 0; i < NS - 1; ++i) {
      if (i < total) issue(i);
      cp_async_commit();
    }
    int planes = 0;
    int i = 0;
    bool dead = false;
    for (int d = 0; d < limit && !dead; ++d) {
      ++planes;
      const int shift = n_bits - 1 - d;
      for (int c = 0; c < Kt && !dead; ++c) {
        if (relu)  // in flight while the chunk computes
          load_sf<NI>(sf, sfx, c, N, n0, wn0, t4, bn);
        for (int s = 0; s < S; ++s, ++i) {
          const int v = min(KC, bk - s * KC);
          cp_async_wait<NS - 2>();
          __syncthreads();  // item i landed; every thread is done with i-1
          if (i + NS - 1 < total) issue(i + NS - 1);
          cp_async_commit();
          // W rows from v on hold an earlier item's weights (and q_once
          // columns from v on the next sub-chunk's q); the digits there are
          // zero
          const uint8_t* st = ring + (i % NS) * stage;
          const QT* q_sub = reinterpret_cast<const QT*>(
              geo.q_once ? q_area : st) + (geo.q_once ? c * bk + s * KC : 0);
          extract_digits<QT>(a_s, q_sub,
                             geo.q_stride / static_cast<int>(sizeof(QT)),
                             rbud_s, PM, shift, d, v);
          __syncthreads();
          mma_item<MI, NI>(
              acc, a_s, reinterpret_cast<const __nv_bfloat16*>(st + q_stage),
              p_row, geo.p_part, parts, wm0, wn0, lane);
        }
        if (relu && tile_dead<MI, NI>(acc, sf, tot_c, pow2(shift), tail, wm0,
                                        wn0, g, t4, bm, bn))
          dead = true;
      }
    }
    cp_async_wait_all();
    store_tile<MI, NI>(acc, out, used, m0, n0, N,
                       blockIdx.x * DSLOT_NT + DSLOT_TILE, planes, dead,
                       relu, wm0, wn0, g, t4, bm, bn);
    return;
  }

  if constexpr (NI == 1 && (MI == 1 || MI == 4)) {
    // ---- resident, 8 columns: W parts once per block, laid out per
    // sub-chunk with rows permuted for the register digits, zero past each
    // chunk's end
    __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + geo.off_p);
    auto issue_q = [&](int tile, int buf) {  // a tile's q rows: one run
      copy_rows(q_area + buf * geo.q_bytes, 0,
                reinterpret_cast<const uint8_t*>(
                    q + static_cast<long long>(tile) * bm * K),
                0, 1, bm * K * static_cast<int>(sizeof(QT)));
    };
    int tile = blockIdx.x;
    if (tile < Mt) issue_q(tile, 0);
    cp_async_commit();
    const int ck = S * KC;  // rows per chunk in the parts layout
    for (int e = threadIdx.x; e < T * KC * PN; e += blockDim.x) {
      const int n = e % PN;
      const int kr = e / PN;
      const int c = kr / ck;
      const int kc = kr - c * ck;
      const float x = (n < bn && kc < bk)
          ? load_w(w, wtype, static_cast<long long>(c * bk + kc) * N + n0 + n)
          : 0.0f;
      split_w(p_s + perm_k(kr) * p_row + n, geo.p_part, x, parts);
    }
    // one sub-chunk covers K (the conv): the words of q, the W fragments and
    // the suffix sums are the same on every plane, so they stay in registers
    const bool words = sizeof(QT) == 1 && T == 1 && n_bits <= 8;
    uint32_t b[2][3][NI][2];
    if (relu && Kt == 1) load_sf<NI>(sf, sfx, 0, N, n0, wn0, t4, bn);

    for (int it = 0; tile < Mt; ++it, tile += gridDim.x) {
      const long long m0 = static_cast<long long>(tile) * bm;
      const int next = tile + gridDim.x;
      if (next < Mt) issue_q(next, (it + 1) & 1);
      cp_async_commit();
      fill_budgets(m0);
      cp_async_wait<1>();
      __syncthreads();  // this tile's q, its budgets and the W parts are in
      const QT* q_flat = reinterpret_cast<const QT*>(q_area + (it & 1) *
                                                     geo.q_bytes);
      zero_tile<MI, NI>(acc);
      int planes = 0;
      bool dead = false;
      if (words) {
        if (it == 0) load_b<NI>(b, p_s, p_row, geo.p_part, parts, wn0, lane);
        const int k4 = 4 * t4;
        uint32_t mag[MI][2][2], neg[MI][2][2];  // [mi][k step][row half]
        int rb[MI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm0 + mi * 16 + g + 8 * h;
            rb[mi][h] = rbud_s[r];
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
              mag_neg4<QT>(load_word4(q_flat + r * K + 16 * ks + k4,
                                      bk - 16 * ks - k4),
                           mag[mi][ks][h], neg[mi][ks][h]);
          }
        constexpr int G = MI * NI <= 4 ? MI : 1;
        for (int d = 0; d < limit && !dead; ++d) {
          ++planes;
          const int shift = n_bits - 1 - d;
          const uint32_t e_bits = static_cast<uint32_t>(127 + shift) << 7;
#pragma unroll
          for (int m0g = 0; m0g < MI; m0g += G) {
            uint32_t a[G][2][4];
#pragma unroll
            for (int gg = 0; gg < G; ++gg)
#pragma unroll
              for (int ks = 0; ks < 2; ++ks)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  decode4(mag[m0g + gg][ks][h], neg[m0g + gg][ks][h], shift,
                          e_bits, rb[m0g + gg][h] > d, a[gg][ks][h],
                          a[gg][ks][h + 2]);
            float t[G][NI][4];
            mma_steps<G, NI>(t, a, b, parts);
#pragma unroll
            for (int gg = 0; gg < G; ++gg) flush<NI>(acc[m0g + gg], t[gg]);
          }
          if (relu && tile_dead<MI, NI>(acc, sf, tot_c, pow2(shift), tail,
                                          wm0, wn0, g, t4, bm, bn))
            dead = true;
        }
      } else {
        for (int d = 0; d < limit && !dead; ++d) {
          ++planes;
          const int shift = n_bits - 1 - d;
          for (int c = 0; c < Kt && !dead; ++c) {
            if (relu && Kt > 1) load_sf<NI>(sf, sfx, c, N, n0, wn0, t4, bn);
            for (int s = 0; s < S; ++s)
              mma_item_reg<MI, NI, QT>(
                  acc, q_flat + c * bk + s * KC, K, rbud_s,
                  p_s + (c * S + s) * KC * p_row, p_row, geo.p_part, parts,
                  shift, d, min(KC, bk - s * KC), wm0, wn0, lane);
            if (relu && tile_dead<MI, NI>(acc, sf, tot_c, pow2(shift), tail,
                                            wm0, wn0, g, t4, bm, bn))
              dead = true;
          }
        }
      }
      store_tile<MI, NI>(acc, out, used, m0, n0, N,
                         tile * DSLOT_NT + DSLOT_TILE, planes, dead, relu,
                         wm0, wn0, g, t4, bm, bn);
      __syncthreads();  // done with this q buffer and the budgets
    }
    cp_async_wait_all();
  }
}

#undef DSLOT_NT
#undef DSLOT_TILE

// ------------------------------------------------------------ C. walk

// The tiles that neither plane_kernel's warp tilings nor a cluster of
// cluster_kernel take (header note C): whose f32 sums exceed what 16 blocks
// of 16 warps hold in registers.  A 1024 x 136 tile's f32 sums alone are
// 557 KB, more than one SM's registers and shared memory together, so here
// the tile's sums live in its own region of `out` between its chunks (the
// L2 holds them), and the block walks the tile in sub-tiles of SR x SC: for
// each (plane, chunk) and sub-tile it loads its sums, stages each KC-row
// sub-chunk's q rows and W parts, writes the digit tile, and each warp walks
// up to WALK_FRAGS 16 x 8 fragments of the sub-tile (mma_item<1, 1>, the
// same products and round-to-nearest adds as every other tiling, so the
// sums are bit-identical); after the chunk's last sub-chunk the warp adds
// its fragments' votes and stores them.  The vote is ANDed over the whole
// logical tile once every sub-tile of the chunk is done, pad rows voting
// as in plane_kernel, and planes_used counts the tile's planes.  Simple
// and slow: every sub-chunk is staged again for each sub-tile and the
// sums cross the L2 once a chunk.
constexpr int WALK_WARPS = 16;
constexpr int WALK_FRAGS = 4;        // fragments a warp walks per sub-tile
constexpr int WALK_MAX_ROWS = 512;   // sub-tile rows: int32 q rows fit

struct WalkGeom {
  int SR, SC;          // sub-tile rows (multiple of 16) and columns (of 8)
  int PN;              // block_n padded to 8: split_parts_kernel's PN
  int q_stride;        // staged q row stride, bytes
  int off_a, off_q, off_p;  // shared-memory offsets, bytes
  int p_row, p_part;   // bf16 elements per staged W row and part
  int smem;            // dynamic shared memory, bytes
  int Nt, y0;          // N tiles, and this launch's first (grid.y's limit)
};

// Shared memory: row budgets [SR] i32 | digit tile [SR][AS] bf16 | q rows
// [SR][q_stride] of a sub-chunk | W parts [parts][KC][p_row] of a
// sub-chunk's columns [c0, c0 + SC), copied from `wp` (split_parts_kernel).
template <typename QT>
__global__ void __launch_bounds__(WALK_WARPS * 32) walk_kernel(
    const QT* __restrict__ q, int wtype, const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ sfx, const float* __restrict__ tot,
    const int* __restrict__ npl_ptr, const int* __restrict__ bnd,
    const int* __restrict__ bud, float* __restrict__ out,
    int* __restrict__ used, int K, int N, int n_bits, int D, int bm, int bn,
    int bk, int relu, WalkGeom geo) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* rb_s = reinterpret_cast<int*>(smem);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem + geo.off_a);
  uint8_t* q_s = smem + geo.off_q;
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + geo.off_p);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int nt = blockIdx.y + geo.y0;
  const long long m0 = static_cast<long long>(blockIdx.x) * bm;
  const int n0 = nt * bn;
  const int parts = wtype == W_F32 ? 3 : 1;
  const int PM = (bm + 15) / 16 * 16;
  const int Kt = K / bk;
  const int S = (bk + KC - 1) / KC;
  const long long tile_elems = static_cast<long long>(bm) * bn;
  const int npl = *npl_ptr;
  const int limit = min(min(D, npl), bnd[nt]);
  const float tail = pow2(n_bits - npl);

  for (long long e = threadIdx.x; e < tile_elems; e += blockDim.x)
    out[(m0 + e / bn) * N + n0 + e % bn] = 0.0f;
  // staged W rows past a chunk's end meet zero digits and must be finite
  for (int e = threadIdx.x; e < parts * geo.p_part; e += blockDim.x)
    reinterpret_cast<uint16_t*>(p_s)[e] = 0;

  float acc[WALK_FRAGS][1][1][4];
  float sf[1][2], tot_c[1][2];
  int planes = 0;
  bool dead = false;
  for (int d = 0; d < limit && !dead; ++d) {
    ++planes;
    const int shift = n_bits - 1 - d;
    for (int c = 0; c < Kt && !dead; ++c) {
      int ok = 1;
      for (int r0 = 0; r0 < PM; r0 += geo.SR)
        for (int c0 = 0; c0 < geo.PN; c0 += geo.SC) {
          const int sr = min(geo.SR, PM - r0);
          const int cf = min(geo.SC, geo.PN - c0) / 8;  // fragment columns
          const int frags = sr / 16 * cf;
          __syncthreads();  // the last sub-tile is done with shared memory
          for (int r = threadIdx.x; r < sr; r += blockDim.x)
            rb_s[r] = r0 + r >= bm ? 0 : (bud == nullptr ? D
                                                          : bud[m0 + r0 + r]);
#pragma unroll
          for (int j = 0; j < WALK_FRAGS; ++j) {
            const int f = warp + j * WALK_WARPS;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = r0 + f / cf * 16 + g + 8 * (e >> 1);
              const int col = c0 + f % cf * 8 + 2 * t4 + (e & 1);
              acc[j][0][0][e] = f < frags && row < bm && col < bn
                  ? out[(m0 + row) * N + n0 + col] : 0.0f;
            }
          }
          for (int s = 0; s < S; ++s) {
            const int k0 = c * bk + s * KC;
            const int v = min(KC, bk - s * KC);
            __syncthreads();  // every warp is done with the last sub-chunk
            copy_rows(q_s, geo.q_stride,
                      reinterpret_cast<const uint8_t*>(q + (m0 + r0) * K + k0),
                      static_cast<long long>(K) * sizeof(QT), min(sr, bm - r0),
                      v * static_cast<int>(sizeof(QT)));
            for (int p = 0; p < parts; ++p)
              copy_rows(reinterpret_cast<uint8_t*>(p_s + p * geo.p_part),
                        geo.p_row * 2,
                        reinterpret_cast<const uint8_t*>(
                            wp + ((p * static_cast<long long>(K) + k0) *
                                      geo.Nt + nt) * geo.PN + c0),
                        static_cast<long long>(geo.Nt) * geo.PN * 2, v,
                        cf * 16);
            cp_async_wait_all();
            __syncthreads();
            extract_digits<QT>(a_s, reinterpret_cast<const QT*>(q_s),
                               geo.q_stride / static_cast<int>(sizeof(QT)),
                               rb_s, sr, shift, d, v);
            __syncthreads();
#pragma unroll
            for (int j = 0; j < WALK_FRAGS; ++j) {
              const int f = warp + j * WALK_WARPS;
              if (f < frags)
                mma_item<1, 1>(acc[j], a_s, p_s, geo.p_row, geo.p_part, parts,
                               f / cf * 16, f % cf * 8, lane);
            }
          }
#pragma unroll
          for (int j = 0; j < WALK_FRAGS; ++j) {
            const int f = warp + j * WALK_WARPS;
            if (f >= frags) continue;
            const int wm0 = r0 + f / cf * 16;
            const int wn0 = c0 + f % cf * 8;
            if (relu) {
              load_sf<1>(sf, sfx, c, N, n0, wn0, t4, bn);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int col = wn0 + 2 * t4 + h;
                tot_c[0][h] = col < bn ? tot[n0 + col] : 0.0f;
              }
              ok &= tile_votes<1, 1>(acc[j], sf, tot_c, pow2(shift), tail,
                                     wm0, wn0, g, t4, bm, bn);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = wm0 + g + 8 * (e >> 1);
              const int col = wn0 + 2 * t4 + (e & 1);
              if (row < bm && col < bn)
                out[(m0 + row) * N + n0 + col] = acc[j][0][0][e];
            }
          }
        }
      if (relu && __syncthreads_and(ok)) dead = true;
    }
  }
  __syncthreads();  // every sum is in `out`
  if (relu)
    for (long long e = threadIdx.x; e < tile_elems; e += blockDim.x) {
      float* o = out + (m0 + e / bn) * N + n0 + e % bn;
      *o = dead ? 0.0f : fmaxf(*o, 0.0f);
    }
  if (threadIdx.x == 0) used[blockIdx.x * geo.Nt + nt] = planes;
}

// ------------------------------------------------------------ D. band

// The streamed ReLU tiles of the serving shapes (header note D): one block,
// or one 2-block cluster, per N tile of 128 columns and band of up to
// BAND_ROWS rows, the band holding 128 / block_m logical vote tiles.
constexpr int BAND_ROWS = 128;
constexpr int BAND_KC = 64;            // K rows of a sub-chunk: a 128-byte
                                       // swizzle row of bf16 digits
constexpr int BAND_TILES = BAND_ROWS / 16;  // vote tiles of a band, at most
constexpr int BAND_MAX_STAGES = 8;
constexpr int BAND_BOX = 64 * 64 * 2;  // one W part's 64 x 64 TMA box, bytes

struct BandGeom {
  int Mp, K, N, n_bits, D, bm, lbm, bk;  // lbm: log2(block_m)
  int band;         // rows of a band: BAND_ROWS, or 64 (band_launch)
  int parts;        // bf16 parts of W: 1 or 3
  int ns;           // ring stages
  int Nt;           // N tiles
  int stage;        // bytes of one ring stage: the W boxes, then q [NB][64]
  int off_ring, off_bar, off_bud, off_vote;  // shared-memory offsets
  int smem;         // dynamic shared memory, bytes (1024 of it alignment)
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_addr(bar);
  unsigned ok = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!ok);
}

// One 2-D TMA box of `map` at element coordinates (x, y) into dst; its
// bytes count against bar's transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(y)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Every wgmma group but the newest complete.
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Barrier `id` (not 0, __syncthreads') over `threads` threads: one
// warpgroup's warps.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Generic-proxy writes to shared memory (the digit tile) made visible to
// the async proxy that wgmma reads it through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A @ B for m64nNk16, bf16 in, f32 sums: A (64 x 16) from registers
// in mma.m16n8k16's per-warp fragment layout, B (16 x N) K-major from the
// shared memory that `desc` describes; scale_d 0 starts from zero.
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int NB>
__device__ __forceinline__ void wgmma_band(float (&d)[NB / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (NB == 16) wgmma_n16(d, a, desc, scale_d);
  else if constexpr (NB == 32) wgmma_n32(d, a, desc, scale_d);
  else if constexpr (NB == 64) wgmma_n64(d, a, desc, scale_d);
  else wgmma_n128(d, a, desc, scale_d);
}

// Descriptor of a K-major operand with 128-byte swizzle: rows of 128 bytes
// (64 bf16 of K), 8-row atoms of 1024 bytes (the stride between them), the
// buffer 1024-byte aligned; a 16-wide k step adds 32 bytes (2 units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Digit plane d of a sub-chunk's q rows (int8, [NB][64] as the TMA box
// lands) into the digit tile [NB][64] bf16, K-major with 128-byte swizzle
// (the 16-byte chunk kc of row r at kc ^ (r % 8)).  A thread decodes 8 q
// of one row at a time; a warp reads 4 whole rows and writes 512
// contiguous bytes.
template <int NB, int THREADS>
__device__ __forceinline__ void band_digits(uint8_t* dst, const uint8_t* q_s,
                                            const int* rbud_s, int shift,
                                            int d) {
  const uint32_t e_bits = static_cast<uint32_t>(127 + shift) << 7;
#pragma unroll
  for (int u0 = 0; u0 < NB * 8; u0 += THREADS) {
    const int u = u0 + static_cast<int>(threadIdx.x);
    if (NB * 8 % THREADS == 0 || u < NB * 8) {
      const int r = u >> 3;
      const int kc = u & 7;
      const uint2 x = *reinterpret_cast<const uint2*>(q_s + r * BAND_KC +
                                                      kc * 8);
      const bool live = rbud_s[r] > d;
      uint32_t mag, neg, l0, h0, l1, h1;
      mag_neg4<int8_t>(x.x, mag, neg);
      decode4(mag, neg, shift, e_bits, live, l0, h0);
      mag_neg4<int8_t>(x.y, mag, neg);
      decode4(mag, neg, shift, e_bits, live, l1, h1);
      *reinterpret_cast<uint4*>(dst + r * 128 + ((kc ^ (r & 7)) << 4)) =
          make_uint4(l0, h0, l1, h1);
    }
  }
}

// A = W^T fragments of the warp's 16 columns for the 4 k steps of a
// sub-chunk, from one part's 64 x 64 TMA box (128-byte swizzle: the 16-byte
// chunk c of K row k sits at c ^ (k % 8)), transposed by ldmatrix.
__device__ __forceinline__ void band_a(uint32_t (&a)[4][4],
                                       const uint8_t* box, int wq, int lane) {
  const int j = lane >> 3;
  const int rr = lane & 7;
  const int chunk = 2 * wq + (j & 1);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int k = 16 * ks + (j >> 1) * 8 + rr;
    ldsm_x4_t(a[ks], box + k * 128 + ((chunk ^ rr) << 4));
  }
}

// One k step KS of a sub-chunk into sums t from zero: its one or three
// parts' products (lo, mid, hi), for the votes inside a sub-chunk.
template <int NB, int KS>
__device__ __forceinline__ void band_step(float (&t)[NB / 2],
                                          const uint32_t (&a)[3][4][4],
                                          uint64_t desc, int parts) {
  if (parts == 1) {
    wgmma_band<NB>(t, a[0][KS], desc + 2 * KS, 0);
  } else {
#pragma unroll
    for (int p = 2; p >= 0; --p)
      wgmma_band<NB>(t, a[p][KS], desc + 2 * KS, p != 2);
  }
}

// The largest plane bound of the column tiles of bn columns in a block's
// columns [n0, n0 + BN) that lie inside N, at most min(D, npl).
__device__ __forceinline__ int cols_limit(const int* bnd, long long n0, int N,
                                          int bn, int BN, int D, int npl) {
  int lim = 0;
  for (long long c = n0; c < n0 + BN && c < N; c += bn)
    lim = max(lim, bnd[c / bn]);
  return min(min(D, npl), lim);
}

// The 8 bits of x, one in the low bit of each of 8 nibbles.
__device__ __forceinline__ unsigned nibbles(unsigned x) {
  unsigned s = 0u;
#pragma unroll
  for (int v = 0; v < 8; ++v) s |= ((x >> v) & 1u) << (4 * v);
  return s;
}

// COLS 3: the AND of the vote bytes of a column tile's n 8-column groups
// from g0 on; group g's byte is byte g % 2 of its warp's word g / 2.
__device__ __forceinline__ unsigned tile_and(const unsigned* vs, int g0,
                                             int n) {
  unsigned all = 0xffu;
  for (int g = g0; g < g0 + n; ++g) all &= vs[g >> 1] >> ((g & 1) * 8);
  return all & 0xffu;
}

// Shared memory (1024-byte aligned): two digit tiles [NB][128 B] | ns ring
// stages, each the W boxes [part][warpgroup][64 K rows][64 columns] bf16
// (TMA, 128-byte swizzle) and the q box [NB][64] int8 | ns mbarriers | row
// budgets [NB] | vote words.  Warpgroup wg computes the transposed product
// for 64 columns: wgmma's M is the columns, its N the band's NB rows.  An N
// tile is BN = 64 * NWG columns, or twice that over a 2-block cluster, each
// block taking its half: 128 columns at <16, 1, true> and <NB, 2, false>,
// 256 (the wide tiles of block_n 256) at <NB, 2, true>.
// Thread (warp wq of its warpgroup, lane g * 4 + t4) holds columns ca and
// ca + 8 of rows 8j + 2 t4 + {0, 1}: sums [4j + e], e = 2 * (column) + row.
// COLS 0: a vote tile spans its N tile's BN columns.  COLS 1 and 2, the
// narrow tiles (block_n bn = N / Nt of 16, 32 or 64; never over a cluster):
// a block of BN columns holds BN / bn column tiles, and a warp's 16
// columns lie in one.  COLS 3 (bn 24, 40, 48 or 56, chunks of whole
// sub-chunks, two warpgroups): a block holds the BN / bn whole column tiles
// of its bw columns, a thread's columns ca and cb may lie in two, and each
// vote tile is joined from the bytes its 8-column groups write, after the
// per-sub-chunk barrier.  A vote tile (a row tile by a column tile) is voted
// by the warps of its column tile: one warp, or 2 or 4 of a warpgroup
// joined through a shared word and the warpgroup's named barrier.  Each
// column tile runs to its own plane bound, the block to the largest; a
// column tile past N (the last block of an N that 128 does not divide)
// keeps nothing.  The block stops at its per-sub-chunk barrier once none
// of its tiles is alive.  COLS 1 votes at the end of each logical chunk of
// whole sub-chunks; COLS 2 (chunks of 16 or 32 rows) after every one or two
// k steps: each k step's product runs into one of two sets of sums from
// zero while the other is added, each thread's part of a chunk's vote is
// taken right after its sums, and the tile joins them once a sub-chunk.
template <int NB, int NWG, bool CLUSTER, int COLS>
__global__ void __launch_bounds__(NWG * 128, 1) band_kernel(
    const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_q, const float* __restrict__ sfx,
    const float* __restrict__ tot, const int* __restrict__ npl_ptr,
    const int* __restrict__ bnd, const int* __restrict__ bud,
    float* __restrict__ out, int* __restrict__ used, BandGeom geo) {
  constexpr int THREADS = NWG * 128;
  constexpr int NR = NB / 2;  // sums per thread
  constexpr int BN = 64 * NWG * (CLUSTER ? 2 : 1);  // columns of an N tile
  extern __shared__ uint8_t band_raw[];
  uint8_t* smem = band_raw + ((1024 - (smem_addr(band_raw) & 1023)) & 1023);
  uint8_t* dig = smem;
  uint8_t* ring = smem + geo.off_ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + geo.off_bar);
  int* rbud_s = reinterpret_cast<int*>(smem + geo.off_bud);
  unsigned* vote_s = reinterpret_cast<unsigned*>(smem + geo.off_vote);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int t4 = lane & 3;
  const int half = CLUSTER ? static_cast<int>(blockIdx.x & 1) : 0;
  const int nt = CLUSTER ? static_cast<int>(blockIdx.x >> 1)
                         : static_cast<int>(blockIdx.x);
  const long long r0 = static_cast<long long>(blockIdx.y) * geo.band;
  const int N = geo.N;
  const int K = geo.K;
  // COLS 3: the block's bw columns, the whole column tiles its BN hold
  const int bw = COLS == 3 ? BN / (N / geo.Nt) * (N / geo.Nt) : BN;
  const long long n0 = static_cast<long long>(nt) * bw;
  const int ca = (half * NWG + wg) * 64 + wq * 16 + (lane >> 2);
  const int cb = ca + 8;
  const int rows = static_cast<int>(
      min(static_cast<long long>(geo.band), geo.Mp - r0));
  const int tiles = rows >> geo.lbm;
  const int npl = *npl_ptr;
  // COLS: the width of a column tile, whether this thread's lies inside N,
  // and its plane bound (0 past N); COLS 3 the same for column cb's tile
  const int bn = COLS ? N / geo.Nt : BN;
  const bool real =
      COLS == 3 ? ca < bw && n0 + ca < N : !COLS || n0 + ca < N;
  const bool real_b = COLS == 3 ? cb < bw && n0 + cb < N : real;
  const int lim_t =
      COLS && real ? min(min(geo.D, npl), bnd[(n0 + ca) / bn]) : 0;
  const int lim_b =
      COLS == 3 && real_b ? min(min(geo.D, npl), bnd[(n0 + cb) / bn]) : 0;
  const int limit = COLS ? cols_limit(bnd, n0, N, bn, bw, geo.D, npl)
                         : min(min(geo.D, npl), bnd[nt]);
  const float tail = pow2(geo.n_bits - npl);
  const int T = K / BAND_KC;       // sub-chunks of a plane
  const int S = geo.bk / BAND_KC;  // sub-chunks of a logical chunk
  const int total = limit > 0 ? limit * T : 0;
  const int ns = geo.ns;
  const int wbytes = geo.parts * NWG * BAND_BOX;
  // COLS: the warpgroups' W boxes that start inside N (TMA fills the
  // columns past N of the last one with zeros)
  const int nbox =
      COLS ? min(NWG, static_cast<int>((N - n0 + 63) / 64)) : NWG;

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = tid; r < NB; r += THREADS)
    rbud_s[r] = r0 + r < geo.Mp ? (bud == nullptr ? geo.D : bud[r0 + r]) : 0;
  __syncthreads();

  const CUtensorMap* map_w = &tm_w;
  const CUtensorMap* map_q = &tm_q;
  // the next item to fetch (thread 0 fetches, every thread counts): its
  // stage and its sub-chunk within the plane
  int fetched = 0, i_stage = 0, i_sub = 0;
  auto fetch = [&]() {
    if (tid == 0) {
      uint8_t* st = ring + i_stage * geo.stage;
      const int k0 = i_sub * BAND_KC;
      mbar_expect_tx(full + i_stage,
                     (COLS ? geo.parts * nbox * BAND_BOX : wbytes) +
                         NB * BAND_KC);
      for (int p = 0; p < geo.parts; ++p)
        for (int h = 0; h < (COLS ? nbox : NWG); ++h)
          tma_load_2d(st + (p * NWG + h) * BAND_BOX, map_w, full + i_stage,
                      static_cast<int>(n0) + (half * NWG + h) * 64, p * K + k0);
      tma_load_2d(st + wbytes, map_q, full + i_stage, k0,
                  static_cast<int>(r0));
    }
    ++fetched;
    if (++i_stage == ns) i_stage = 0;
    if (++i_sub == T) i_sub = 0;
  };
  while (fetched < min(ns, total)) fetch();

  float acc[NR], t[NR];
#pragma unroll
  for (int e = 0; e < NR; ++e) acc[e] = t[e] = 0.0f;
  unsigned alive = (1u << tiles) - 1u;
  if constexpr (COLS != 0) {
    if (lim_t == 0) alive = 0u;
  }
  if constexpr (COLS == 3) {  // bits 8-15: the row tiles of cb's column tile
    if (lim_b != 0) alive |= ((1u << tiles) - 1u) << 8;
  }
  unsigned died = 0u;
  int planes[BAND_TILES];
#pragma unroll
  for (int v = 0; v < BAND_TILES; ++v) planes[v] = 0;
  // COLS 3: the planes of the row tiles of ca's and cb's column tiles, a
  // nibble each (at most 8)
  unsigned planes_a = 0u, planes_b = 0u;
  const float tot_a = real ? tot[n0 + ca] : 0.0f;
  const float tot_b = real_b ? tot[n0 + cb] : 0.0f;
  float sf_a = 0.0f, sf_b = 0.0f;
  int waited = -1;  // the last item every thread has waited for
  int votes = 0;
  if (total > 0) {
    mbar_wait(full, 0);
    waited = 0;
    band_digits<NB, THREADS>(dig, ring + wbytes, rbud_s, geo.n_bits - 1, 0);
    fence_proxy_async();
    __syncthreads();
  }
  if constexpr (COLS == 0) {
  // item i: stage st_i with parity ph_i, plane d, sub-chunk r of the plane,
  // sub-chunk sc of logical chunk c
  int st_i = 0, ph_i = 0, d = 0, r = 0, sc = 0, c = 0;
  for (int i = 0; i < total; ++i) {
    if (r == 0) {  // the band enters plane d
#pragma unroll
      for (int v = 0; v < BAND_TILES; ++v) planes[v] += (alive >> v) & 1u;
      c = 0;
    }
    if (sc == 0) {  // in flight while the chunk computes
      sf_a = sfx[static_cast<long long>(c) * N + n0 + ca];
      sf_b = sfx[static_cast<long long>(c) * N + n0 + cb];
    }
    const uint8_t* st = ring + st_i * geo.stage;
    const uint64_t desc = sw128_desc(dig + (i & 1) * NB * 128);
    if (geo.parts == 1) {
      uint32_t a[4][4];
      band_a(a, st + wg * BAND_BOX, wq, lane);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_band<NB>(t, a[ks], desc + 2 * ks, ks != 0);
    } else {  // lo, mid, hi per k step
      uint32_t a[3][4][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        band_a(a[p], st + (p * NWG + wg) * BAND_BOX, wq, lane);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int p = 2; p >= 0; --p)
          wgmma_band<NB>(t, a[p][ks], desc + 2 * ks, ks != 0 || p != 2);
    }
    wgmma_commit();
    // the next item's place
    const int st_n = st_i + 1 == ns ? 0 : st_i + 1;
    const int ph_n = st_n == 0 ? ph_i ^ 1 : ph_i;
    const int r_n = r + 1 == T ? 0 : r + 1;
    const int d_n = r_n == 0 ? d + 1 : d;
    if (i + 1 < total) {  // the next digits while the products run
      mbar_wait(full + st_n, ph_n);
      waited = i + 1;
      band_digits<NB, THREADS>(dig + ((i + 1) & 1) * NB * 128,
                               ring + st_n * geo.stage + wbytes, rbud_s,
                               geo.n_bits - 1 - d_n, d_n);
      fence_proxy_async();
    }
    wgmma_wait0();
    reg_fence<NR>(t);
#pragma unroll
    for (int e = 0; e < NR; ++e) acc[e] = __fadd_rn(acc[e], t[e]);
    __syncthreads();  // stage st_i and digit tile i are free; digits i+1 are in
    if (fetched < total) fetch();
    const int d_i = d;
    st_i = st_n, ph_i = ph_n, r = r_n, d = d_n;
    if (++sc < S) continue;
    sc = 0;
    ++c;
    // the vote at the end of a logical chunk, per vote tile
    const float scale = pow2(geo.n_bits - 1 - d_i);
    const float rem_a = __fadd_rn(__fmul_rn(scale, sf_a),
                                  __fmul_rn(scale - tail, tot_a));
    const float rem_b = __fadd_rn(__fmul_rn(scale, sf_b),
                                  __fmul_rn(scale - tail, tot_b));
    unsigned bad = 0u;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int ok = static_cast<int>(__fadd_rn(acc[4 * j], rem_a) < 0.0f) &
                     static_cast<int>(__fadd_rn(acc[4 * j + 1], rem_a) < 0.0f) &
                     static_cast<int>(__fadd_rn(acc[4 * j + 2], rem_b) < 0.0f) &
                     static_cast<int>(__fadd_rn(acc[4 * j + 3], rem_b) < 0.0f);
      bad |= static_cast<unsigned>(ok ^ 1) << ((8 * j) >> geo.lbm);
    }
    // rows past the NB computed: the wrapper's pad rows, whose sums are 0
    if (NB < rows && !(rem_a < 0.0f && rem_b < 0.0f))
      bad |= ~0u << (NB >> geo.lbm);
    unsigned* vs = vote_s + (votes & 1) * 8;
    const unsigned wmask = __reduce_and_sync(0xffffffffu, ~bad);
    if (lane == 0) vs[warp] = wmask;
    __syncthreads();
    unsigned all = ~0u;
#pragma unroll
    for (int w = 0; w < NWG * 4; ++w) all &= vs[w];
    if constexpr (CLUSTER) {  // join the other half's vote
      cg::cluster_group cluster = cg::this_cluster();
      unsigned* bs = vote_s + 16 + (votes & 1);
      if (tid == 0) *bs = all;
      cluster.sync();
      all &= *cluster.map_shared_rank(bs, cluster.block_rank() ^ 1u);
    }
    ++votes;
    died |= all & alive;
    alive &= ~all;
    if (alive == 0u) break;
  }
  } else {  // COLS 1, 2 and 3
    // COLS 3: ok_bits for columns ca (bits 0-7) and cb (bits 8-15) apart
    auto ok_halves = [&](float s_a, float s_b, int dv) -> unsigned {
      const float scale = pow2(geo.n_bits - 1 - dv);
      const float rem_a = __fadd_rn(__fmul_rn(scale, s_a),
                                    __fmul_rn(scale - tail, tot_a));
      const float rem_b = __fadd_rn(__fmul_rn(scale, s_b),
                                    __fmul_rn(scale - tail, tot_b));
      unsigned bad_a = 0u, bad_b = 0u;
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        const int v = (8 * j) >> geo.lbm;
        const int ok_a =
            static_cast<int>(__fadd_rn(acc[4 * j], rem_a) < 0.0f) &
            static_cast<int>(__fadd_rn(acc[4 * j + 1], rem_a) < 0.0f);
        const int ok_b =
            static_cast<int>(__fadd_rn(acc[4 * j + 2], rem_b) < 0.0f) &
            static_cast<int>(__fadd_rn(acc[4 * j + 3], rem_b) < 0.0f);
        bad_a |= static_cast<unsigned>(ok_a ^ 1) << v;
        bad_b |= static_cast<unsigned>(ok_b ^ 1) << v;
      }
      // rows past the NB computed: the wrapper's pad rows, whose sums are 0
      if (NB < rows && !(rem_a < 0.0f)) bad_a |= ~0u << (NB >> geo.lbm);
      if (NB < rows && !(rem_b < 0.0f)) bad_b |= ~0u << (NB >> geo.lbm);
      return (~bad_a & 0xffu) | ((~bad_b & 0xffu) << 8);
    };
    // This thread's part of the vote on the chunk that ends here (suffix
    // sums s_a, s_b at plane dv): a bit per row tile whose elements here
    // all have acc + R < 0.
    auto ok_bits = [&](float s_a, float s_b, int dv) -> unsigned {
      const float scale = pow2(geo.n_bits - 1 - dv);
      const float rem_a = __fadd_rn(__fmul_rn(scale, s_a),
                                    __fmul_rn(scale - tail, tot_a));
      const float rem_b = __fadd_rn(__fmul_rn(scale, s_b),
                                    __fmul_rn(scale - tail, tot_b));
      unsigned bad = 0u;
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        const int ok =
            static_cast<int>(__fadd_rn(acc[4 * j], rem_a) < 0.0f) &
            static_cast<int>(__fadd_rn(acc[4 * j + 1], rem_a) < 0.0f) &
            static_cast<int>(__fadd_rn(acc[4 * j + 2], rem_b) < 0.0f) &
            static_cast<int>(__fadd_rn(acc[4 * j + 3], rem_b) < 0.0f);
        bad |= static_cast<unsigned>(ok ^ 1) << ((8 * j) >> geo.lbm);
      }
      // rows past the NB computed: the wrapper's pad rows, whose sums are 0
      if (NB < rows && !(rem_a < 0.0f && rem_b < 0.0f))
        bad |= ~0u << (NB >> geo.lbm);
      return ~bad & 0xffu;
    };
    // The AND of the tile's threads' bits (up to 4 chunks' votes, 8 bits
    // each): its warp's, joined with the other warps of the tile.
    auto join = [&](unsigned bits) -> unsigned {
      unsigned all = __reduce_and_sync(0xffffffffu, bits);
      if (bn > 16) {  // the 2 or 4 warps of the tile, in one warpgroup
        unsigned* vs = vote_s + (votes & 1) * 8;
        if (lane == 0) vs[warp] = all;
        named_sync(1 + wg, 128);
        const int w0 = warp & ~(bn / 16 - 1);
        all = vs[w0];
        for (int w = 1; w < bn / 16; ++w) all &= vs[w0 + w];
      }
      ++votes;
      return all;
    };
    auto settle = [&](unsigned all) {  // a chunk's dead tiles
      died |= all & alive;
      alive &= ~all;
    };
    // k steps' sums into the tile's, until the tile dies or ends at its
    // bound
    auto add = [&](float (&s)[NR]) {
      reg_fence<NR>(s);
      if constexpr (COLS == 3) {  // each column while its tile lives
        const bool on_a = (alive & 0xffu) != 0u;
        const bool on_b = (alive >> 8) != 0u;
#pragma unroll
        for (int e = 0; e < NR; ++e)
          if ((e & 2) ? on_b : on_a) acc[e] = __fadd_rn(acc[e], s[e]);
      } else if (alive != 0u) {
#pragma unroll
        for (int e = 0; e < NR; ++e) acc[e] = __fadd_rn(acc[e], s[e]);
      }
    };
    const int kv = geo.bk >> 4;  // COLS 2: k steps of a logical chunk
    float t2[COLS == 2 ? NR : 1];
#pragma unroll
    for (int e = 0; e < (COLS == 2 ? NR : 1); ++e) t2[e] = 0.0f;
    float sa[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int st_i = 0, ph_i = 0, d = 0, r = 0, sc = 0, c = 0;
    for (int i = 0; i < total; ++i) {
      if (r == 0) {  // the band enters plane d
        if constexpr (COLS == 3) {
          planes_a += nibbles(alive & 0xffu);
          planes_b += nibbles(alive >> 8);
        } else {
#pragma unroll
          for (int v = 0; v < BAND_TILES; ++v) planes[v] += (alive >> v) & 1u;
        }
        c = 0;
      }
      if constexpr (COLS == 3) {
        if (sc == 0) {  // in flight while the chunk computes
          if (real) sa[0] = sfx[static_cast<long long>(c) * N + n0 + ca];
          if (real_b) sb[0] = sfx[static_cast<long long>(c) * N + n0 + cb];
        }
      } else if (real) {  // in flight while the products run
        if constexpr (COLS == 2) {
          const int cps = BAND_KC / geo.bk;  // chunks of the sub-chunk
#pragma unroll
          for (int g = 0; g < 4; ++g)
            if (g < cps) {
              const long long row = static_cast<long long>(r * cps + g) * N;
              sa[g] = sfx[row + n0 + ca];
              sb[g] = sfx[row + n0 + cb];
            }
        } else if (sc == 0) {
          sa[0] = sfx[static_cast<long long>(c) * N + n0 + ca];
          sb[0] = sfx[static_cast<long long>(c) * N + n0 + cb];
        }
      }
      const uint8_t* st = ring + st_i * geo.stage;
      const uint64_t desc = sw128_desc(dig + (i & 1) * NB * 128);
      uint32_t a[3][4][4];
      if (geo.parts == 1) {
        band_a(a[0], st + wg * BAND_BOX, wq, lane);
      } else {
#pragma unroll
        for (int p = 0; p < 3; ++p)
          band_a(a[p], st + (p * NWG + wg) * BAND_BOX, wq, lane);
      }
      // the next item's place
      const int st_n = st_i + 1 == ns ? 0 : st_i + 1;
      const int ph_n = st_n == 0 ? ph_i ^ 1 : ph_i;
      const int r_n = r + 1 == T ? 0 : r + 1;
      const int d_n = r_n == 0 ? d + 1 : d;
      auto next_digits = [&]() {  // while the products run
        if (i + 1 < total) {
          mbar_wait(full + st_n, ph_n);
          waited = i + 1;
          band_digits<NB, THREADS>(dig + ((i + 1) & 1) * NB * 128,
                                   ring + st_n * geo.stage + wbytes, rbud_s,
                                   geo.n_bits - 1 - d_n, d_n);
          fence_proxy_async();
        }
      };
      unsigned mine = 0u;  // COLS 3: this thread's vote bits, if a chunk ends
      bool voted = false;
      wgmma_fence();
      if constexpr (COLS == 1 || COLS == 3) {
        if (geo.parts == 1) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_band<NB>(t, a[0][ks], desc + 2 * ks, ks != 0);
        } else {  // lo, mid, hi per k step
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int p = 2; p >= 0; --p)
              wgmma_band<NB>(t, a[p][ks], desc + 2 * ks, ks != 0 || p != 2);
        }
        wgmma_commit();
        next_digits();
        wgmma_wait0();
        add(t);
        if (++sc == S) {  // the vote at the end of a logical chunk
          sc = 0;
          ++c;
          if constexpr (COLS == 3) {  // each 8-column group's AND, a byte
            mine = ok_halves(sa[0], sb[0], d);
            const unsigned w = __reduce_and_sync(0xffffffffu, mine);
            if (lane == 0) vote_s[(votes & 1) * 8 + warp] = w;
            voted = true;
          } else {
            settle(join(ok_bits(sa[0], sb[0], d)));
          }
        }
      } else {
        // a chunk ends after every kv k steps: each thread's bits for it
        // right after its sums, the tile's AND of all of them once, after
        // the sub-chunk.  Sums added to a tile after it died change no
        // output, and a tile's bound ends only with a plane.
        unsigned bits = 0u;
        band_step<NB, 0>(t, a, desc, geo.parts);
        wgmma_commit();
        band_step<NB, 1>(t2, a, desc, geo.parts);
        wgmma_commit();
        next_digits();
        wgmma_wait1();
        add(t);
        if (kv == 1) bits = ok_bits(sa[0], sb[0], d);
        wgmma_fence();
        band_step<NB, 2>(t, a, desc, geo.parts);
        wgmma_commit();
        wgmma_wait1();
        add(t2);
        bits |= (kv == 1 ? ok_bits(sa[1], sb[1], d)
                         : ok_bits(sa[0], sb[0], d)) << (kv == 1 ? 8 : 0);
        wgmma_fence();
        band_step<NB, 3>(t2, a, desc, geo.parts);
        wgmma_commit();
        wgmma_wait1();
        add(t);
        if (kv == 1) bits |= ok_bits(sa[2], sb[2], d) << 16;
        wgmma_wait0();
        add(t2);
        bits |= (kv == 1 ? ok_bits(sa[3], sb[3], d)
                         : ok_bits(sa[1], sb[1], d)) << (kv == 1 ? 24 : 8);
        const unsigned all = join(bits);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (g < BAND_KC / geo.bk) settle((all >> (8 * g)) & 0xffu);
      }
      if constexpr (COLS == 3) {
        // A vote tile dies when every thread of its column tile's groups
        // votes it dead, so it lives on past this sub-chunk iff one thread
        // of it keeps its bit: the barrier that frees stage st_i tells the
        // block whether any does, and its groups' bytes are in after it.
        unsigned keep = ~0u;  // past a tile's bound, after the settle
        if (r_n == 0 && d_n >= lim_t) keep &= ~0xffu;
        if (r_n == 0 && d_n >= lim_b) keep &= ~0xff00u;
        const bool go = __syncthreads_or((alive & keep & ~mine) != 0u);
        if (voted) {
          const unsigned* vs = vote_s + (votes & 1) * 8;
          const int gs = bn >> 3;  // 8-column groups of a column tile
          unsigned all = 0u;
          if (real) all = tile_and(vs, ca / bn * gs, gs);
          if (real_b) all |= tile_and(vs, cb / bn * gs, gs) << 8;
          settle(all);
          ++votes;
        }
        alive &= keep;
        if (!go) break;
      } else {
        if (r_n == 0 && d_n >= lim_t) alive = 0u;  // past the tile's bound
        // stage st_i and digit tile i are free, digits i+1 are in; the band
        // stops once none of its tiles is alive
        if (!__syncthreads_or(alive != 0u)) break;
      }
      if (fetched < total) fetch();
      st_i = st_n, ph_i = ph_n, r = r_n, d = d_n;
    }
  }
  // a band that stopped early: the boxes still in flight land before exit
  if (tid == 0)
    for (int j = waited + 1; j < fetched; ++j)
      mbar_wait(full + j % ns, (j / ns) & 1);

  if constexpr (COLS == 3) {  // ca's tile's bits 0-7, cb's bits 8-15
#pragma unroll
    for (int j = 0; j < NB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 8 * j + 2 * t4 + (e & 1);
        if (n < rows && ((e >> 1) ? real_b : real)) {
          const int v = (n >> geo.lbm) + (e >> 1) * 8;
          out[(r0 + n) * N + n0 + ((e >> 1) ? cb : ca)] =
              (died >> v) & 1u ? 0.0f : fmaxf(acc[4 * j + e], 0.0f);
        }
      }
  } else {
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * t4 + (e & 1);
      if (n < rows && real) {
        const int v = n >> geo.lbm;
        out[(r0 + n) * N + n0 + ((e >> 1) ? cb : ca)] =
            (died >> v) & 1u ? 0.0f : fmaxf(acc[4 * j + e], 0.0f);
      }
    }
  }
  // rows past the NB computed: zeros
  for (int e = tid; e < (rows - NB) * NWG * 64; e += THREADS) {
    const int n = NB + e / (NWG * 64);
    if constexpr (COLS == 3) {
      const int col = e % (NWG * 64);
      if (col < bw && n0 + col < N) out[(r0 + n) * N + n0 + col] = 0.0f;
    } else if constexpr (COLS != 0) {
      const long long col = n0 + e % (NWG * 64);
      if (col < N) out[(r0 + n) * N + col] = 0.0f;
    } else {
      out[(r0 + n) * N + n0 + half * NWG * 64 + e % (NWG * 64)] = 0.0f;
    }
  }
  if constexpr (COLS == 3) {  // lane 0 of the group a column tile starts
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h ? cb : ca;
        const unsigned pl = h ? planes_b : planes_a;
        if ((h ? real_b : real) && col % bn == 0) {
          const long long ct = (n0 + col) / bn;
#pragma unroll
          for (int v = 0; v < BAND_TILES; ++v)
            if (v < tiles)
              used[((r0 >> geo.lbm) + v) * geo.Nt + ct] =
                  static_cast<int>((pl >> (4 * v)) & 15u);
        }
      }
    }
  } else if constexpr (COLS != 0) {  // the first lane of each column tile
    if (lane == 0 && real && (wq * 16) % bn == 0) {
      const long long ct = (n0 + ca) / bn;
#pragma unroll
      for (int v = 0; v < BAND_TILES; ++v)
        if (v < tiles) used[((r0 >> geo.lbm) + v) * geo.Nt + ct] = planes[v];
    }
  } else if (tid == 0 && half == 0) {
#pragma unroll
    for (int v = 0; v < BAND_TILES; ++v)
      if (v < tiles)
        used[((r0 >> geo.lbm) + v) * geo.Nt + nt] = planes[v];
  }
  if constexpr (CLUSTER) cg::this_cluster().sync();  // no exit while read
}

// ------------------------------------------------------------ E. cluster

// The two halves of a cluster barrier (cluster.sync() is both at once):
// arrive releases this thread's shared-memory writes to the cluster, wait
// acquires every block's writes before their arrive.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The ReLU tiles that neither a warp tiling of B nor the band kernel takes
// (header note E): one logical tile spread over a thread-block cluster of up
// to CL_MAX_BLOCKS blocks.  Block rank b computes the slice of row group
// b / CG and column group b % CG, SR x SC of the physical tile, with its
// sums in registers across every plane and chunk.
constexpr int CL_MAX_BLOCKS = 16;  // a non-portable cluster on Hopper
constexpr int CL_WARPS = 16;       // most warps of a block

struct ClusterGeom {
  int CL;              // blocks of a cluster: one logical tile
  int CG;              // column groups of the tile (row groups: CL / CG)
  int SR, SC;          // a block's slice: rows (a multiple of 16 * MI) and
                       // columns (of 8 * NI)
  int WN;              // warps across a slice's columns
  int PN;              // block_n padded to 8: split_parts_kernel's PN
  int resident;        // 1: W parts of the slice over all of K staged once
  int dt;              // resident: digit tiles, sub-chunks extracted at once
  int q_once;          // the slice's q rows over all of K staged once
  int q_stride;        // staged q row stride, bytes
  int off_a, off_q, off_p, off_vote;  // shared-memory offsets, bytes
  int p_row, p_part;   // bf16 elements per staged W row and part
  int stage;           // streamed: bytes of one ring stage
  int threads;         // threads of a block
  int smem;            // dynamic shared memory, bytes
  int Nt, y0;          // N tiles, and this launch's first (grid.y's limit)
};

// Shared memory: row budgets [SR] i32 | digit tiles [dt][SR][AS] bf16 (one
// where the slice streams) | q_once: the slice's q rows over all of K |
// resident: W parts [part][T * KC][p_row], sub-chunk t at rows t * KC,
// zero past each chunk's end; streamed: NSTAGE ring stages, each (unless
// q_once) the slice's q rows of a KC-column sub-chunk, then the W parts
// [part][KC][p_row] of the slice's columns | two vote words.  W comes from
// `wp` (split_parts_kernel's layout).  Warp w owns rows (w / WN) * 16 * MI
// + [0, 16 * MI) and columns (w % WN) * 8 * NI + [0, 8 * NI) of the slice.
// The grid is (M tiles * CL, N tiles), the cluster (CL, 1, 1): block x
// computes a slice of M tile x / CL.  A resident slice issues no load in
// its loop (the tall tiles: K = 256, 8 to 24 columns): where one warp
// spans its columns (8-column tiles), each warp builds its rows' digits in
// registers (mma_item_reg, W's rows in perm_k's order) and the block
// meets only at the vote; else it extracts the digits of up to dt
// sub-chunks between two barriers.
template <int MI, int NI, typename QT>
__global__ void __launch_bounds__(CL_WARPS * 32, 1) cluster_kernel(
    const QT* __restrict__ q, int wtype, const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ sfx, const float* __restrict__ tot,
    const int* __restrict__ npl_ptr, const int* __restrict__ bnd,
    const int* __restrict__ bud, float* __restrict__ out,
    int* __restrict__ used, int K, int N, int n_bits, int D, int bm, int bn,
    int bk, int relu, ClusterGeom geo) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* rbud_s = reinterpret_cast<int*>(smem);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem + geo.off_a);
  uint8_t* q_area = smem + geo.off_q;
  uint8_t* p_area = smem + geo.off_p;  // resident W, or the ring
  unsigned* vote_s = reinterpret_cast<unsigned*>(smem + geo.off_vote);
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm0 = (warp / geo.WN) * MI * 16;  // in the slice
  const int wn0 = (warp % geo.WN) * NI * 8;
  const int r0 = (rank / geo.CG) * geo.SR;    // the slice in the tile
  const int c0 = (rank % geo.CG) * geo.SC;
  const int tm = static_cast<int>(blockIdx.x) / geo.CL;
  const int nt = static_cast<int>(blockIdx.y) + geo.y0;
  const long long m0 = static_cast<long long>(tm) * bm;
  const int n0 = nt * bn;
  const int parts = wtype == W_F32 ? 3 : 1;
  const int Kt = K / bk;
  const int S = (bk + KC - 1) / KC;  // sub-chunks per logical chunk
  const int T = Kt * S;
  const int npl = *npl_ptr;
  const int limit = min(min(D, npl), bnd[nt]);
  const float tail = pow2(n_bits - npl);
  const int q_rows = max(0, min(geo.SR, bm - r0));      // the slice's q rows
  const int w_cols = max(0, min(geo.SC, geo.PN - c0));  // and W columns
  const int q_row = geo.q_stride / static_cast<int>(sizeof(QT));

  float tot_c[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = c0 + wn0 + ni * 8 + 2 * t4 + j;
      tot_c[ni][j] = col < bn ? tot[n0 + col] : 0.0f;
    }
  float sf[NI][2];
  float acc[MI][NI][4];

  const QT* q_slice = q + (m0 + r0) * K;
  const int q_stage = geo.q_once ? 0 : geo.SR * geo.q_stride;
  const int total = limit * T;  // (plane, chunk, sub-chunk) items
  // W parts of sub-chunk t, rows [0, v), into dst ([part][.][p_row])
  auto copy_w = [&](uint8_t* dst, int t, int v) {
    const int k0 = t / S * bk + t % S * KC;
    if (w_cols > 0)
      for (int p = 0; p < parts; ++p)
        copy_rows(dst + p * geo.p_part * 2, geo.p_row * 2,
                  reinterpret_cast<const uint8_t*>(
                      wp + ((p * static_cast<long long>(K) + k0) * geo.Nt +
                            nt) * geo.PN + c0),
                  static_cast<long long>(geo.Nt) * geo.PN * 2, v,
                  w_cols * 2);
  };
  // resident slices whose warps own whole rows (one warp across the
  // columns) build their digits in registers (mma_item_reg): W's rows go
  // in perm_k's order, 16-byte copies (w_cols and c0 are multiples of 8)
  const bool reg = geo.resident && geo.WN == 1;
  auto copy_w_perm = [&](uint8_t* dst, int t, int v) {
    const int k0 = t / S * bk + t % S * KC;
    const int units = w_cols / 8;
    for (int e = threadIdx.x; e < parts * v * units; e += blockDim.x) {
      const int u = e % units;
      const int r = e / units % v;
      const int p = e / (units * v);
      cp_async16(dst + (p * geo.p_part + perm_k(r) * geo.p_row + u * 8) * 2,
                 wp + ((p * static_cast<long long>(K) + k0 + r) * geo.Nt +
                       nt) * geo.PN + c0 + u * 8);
    }
  };
  auto issue = [&](int item) {  // streamed: one ring stage
    const int t = item % T;
    const int s = t % S;
    const int v = min(KC, bk - s * KC);
    uint8_t* st = p_area + (item % NSTAGE) * geo.stage;
    if (!geo.q_once && q_rows > 0)
      copy_rows(st, geo.q_stride,
                reinterpret_cast<const uint8_t*>(q_slice + t / S * bk +
                                                 s * KC),
                static_cast<long long>(K) * sizeof(QT), q_rows,
                v * static_cast<int>(sizeof(QT)));
    copy_w(st + q_stage, t, v);
  };
  for (int r = threadIdx.x; r < geo.SR; r += blockDim.x)  // pad rows: never live
    rbud_s[r] = r0 + r >= bm ? 0 : (bud == nullptr ? D : bud[m0 + r0 + r]);
  zero_tile<MI, NI>(acc);
  // zero the W area once: W rows past a chunk's end meet zero digits, and
  // W columns past the tile's meet the products of columns never stored;
  // both must be finite
  uint4* z = reinterpret_cast<uint4*>(p_area);
  const int p_bytes = geo.resident ? parts * geo.p_part * 2
                                   : NSTAGE * geo.stage;
  for (int e = threadIdx.x; e < p_bytes / 16; e += blockDim.x)
    z[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (geo.q_once && total > 0 && q_rows > 0)  // lands with the first item
    copy_rows(q_area, geo.q_stride, reinterpret_cast<const uint8_t*>(q_slice),
              static_cast<long long>(K) * sizeof(QT), q_rows,
              K * static_cast<int>(sizeof(QT)));
  if (geo.resident) {
    if (total > 0)
      for (int t = 0; t < T; ++t) {
        uint8_t* dst = p_area + t * KC * geo.p_row * 2;
        const int v = min(KC, bk - t % S * KC);
        if (reg)
          copy_w_perm(dst, t, v);
        else
          copy_w(dst, t, v);
      }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  } else {
    for (int i = 0; i < NSTAGE - 1; ++i) {
      if (i < total) issue(i);
      cp_async_commit();
    }
  }
  int planes = 0;
  int i = 0;
  int votes = 0;
  bool dead = false;
  // The vote of the logical tile: the block's AND (__syncthreads_and) into
  // a word of its shared memory, then the cluster's, every warp reading
  // the blocks' words through distributed shared memory (a lane a block).
  // A vote's cluster barrier is split: a block arrives after writing its
  // word and waits only after computing the next chunk, which a dead tile
  // then drops (its outputs are zeros whatever its sums; planes_used
  // counts the planes entered before the vote).  Two words: a block writes
  // word v & 1 after waiting out vote v - 1, so after every block arrived
  // at it, and so after every block read word v & 1 of vote v - 2.
  bool pending = false;  // a vote arrived at, not yet waited for
  auto join = [&]() {    // wait for the pending vote; true: the tile died
    cluster_wait();
    pending = false;
    const unsigned got =
        lane < geo.CL ? *cluster.map_shared_rank(vote_s + ((votes - 1) & 1),
                                                 static_cast<unsigned>(lane))
                      : 1u;
    return __all_sync(0xffffffffu, got != 0u) != 0;
  };
  for (int d = 0; d < limit && !dead; ++d) {
    ++planes;
    const int shift = n_bits - 1 - d;
    for (int c = 0; c < Kt; ++c) {
      if (relu)  // in flight while the chunk computes
        load_sf<NI>(sf, sfx, c, N, n0, c0 + wn0, t4, bn);
      if (reg) {
        const QT* q_c = reinterpret_cast<const QT*>(q_area) + c * bk;
        const __nv_bfloat16* w_c =
            reinterpret_cast<const __nv_bfloat16*>(p_area) +
            c * S * KC * geo.p_row;
#pragma unroll 4  // independent sub-chunks: their products interleave
        for (int s = 0; s < S; ++s)
          mma_item_reg<MI, NI, QT>(acc, q_c + s * KC, q_row, rbud_s,
                                   w_c + s * KC * geo.p_row, geo.p_row,
                                   geo.p_part, parts, shift, d,
                                   min(KC, bk - s * KC), wm0, wn0, lane);
      } else if (geo.resident) {
        const QT* q_c = reinterpret_cast<const QT*>(q_area) + c * bk;
        for (int s0 = 0; s0 < S; s0 += geo.dt) {
          const int ns = min(geo.dt, S - s0);
          __syncthreads();  // every warp is done with the digit tiles
          for (int j = 0; j < ns; ++j)
            extract_digits<QT>(a_s + j * geo.SR * AS, q_c + (s0 + j) * KC,
                               q_row, rbud_s, geo.SR, shift, d,
                               min(KC, bk - (s0 + j) * KC));
          __syncthreads();
#pragma unroll 4
          for (int j = 0; j < ns; ++j)
            mma_item<MI, NI>(
                acc, a_s + j * geo.SR * AS,
                reinterpret_cast<const __nv_bfloat16*>(p_area) +
                    (c * S + s0 + j) * KC * geo.p_row,
                geo.p_row, geo.p_part, parts, wm0, wn0, lane);
        }
      } else {
        for (int s = 0; s < S; ++s, ++i) {
          const int v = min(KC, bk - s * KC);
          cp_async_wait<NSTAGE - 2>();
          __syncthreads();  // item i landed; every thread is done with i-1
          if (i + NSTAGE - 1 < total) issue(i + NSTAGE - 1);
          cp_async_commit();
          const uint8_t* st = p_area + (i % NSTAGE) * geo.stage;
          const QT* q_sub = reinterpret_cast<const QT*>(
              geo.q_once ? q_area : st) + (geo.q_once ? c * bk + s * KC : 0);
          extract_digits<QT>(a_s, q_sub, q_row, rbud_s, geo.SR, shift, d, v);
          __syncthreads();
          mma_item<MI, NI>(
              acc, a_s, reinterpret_cast<const __nv_bfloat16*>(st + q_stage),
              geo.p_row, geo.p_part, parts, wm0, wn0, lane);
        }
      }
      if (pending && join()) {  // the tile died at the last chunk's vote
        dead = true;
        if (c == 0) --planes;   // this chunk opened a plane it never used
        break;
      }
      if (!relu) continue;
      const int mine = __syncthreads_and(tile_votes<MI, NI>(
          acc, sf, tot_c, pow2(shift), tail, r0 + wm0, c0 + wn0, g, t4, bm,
          bn));
      if (threadIdx.x == 0) vote_s[votes & 1] = static_cast<unsigned>(mine);
      ++votes;
      cluster_arrive();
      pending = true;
    }
  }
  if (pending && join()) dead = true;
  cp_async_wait_all();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + wm0 + mi * 16 + g + 8 * (e >> 1);
        const int col = c0 + wn0 + ni * 8 + 2 * t4 + (e & 1);
        if (row < bm && col < bn) {
          float v = acc[mi][ni][e];
          if (relu) v = dead ? 0.0f : fmaxf(v, 0.0f);
          out[(m0 + row) * N + n0 + col] = v;
        }
      }
  if (rank == 0 && threadIdx.x == 0) used[tm * geo.Nt + nt] = planes;
  cluster.sync();  // no block exits while another may read its votes
}

// ------------------------------------------------------------ launchers

bool product_path(int n_bits, int relu) { return !relu && n_bits <= 24; }

int product_tn(int N) { return N <= 16 ? 16 : 64; }

// K slices of the product path: up to four blocks per SM when the tiles are
// fewer than the SMs, at most one portable cluster of slices, each slice a
// multiple of PT_KS.
int product_splits(int M, int K, int N, int* slice) {
  const long long tiles = static_cast<long long>((M + PT_M - 1) / PT_M) *
                          ((N + product_tn(N) - 1) / product_tn(N));
  const int rounds = (K + PT_KS - 1) / PT_KS;
  int want = 1;
  if (tiles < NUM_SMS) {
    const long long fill = (4 * NUM_SMS + tiles - 1) / tiles;
    want = rounds < PT_MAX_SPLITS ? rounds : PT_MAX_SPLITS;
    if (fill < want) want = static_cast<int>(fill);
  }
  *slice = (rounds + want - 1) / want * PT_KS;
  return (K + *slice - 1) / *slice;
}

template <typename QT>
int launch_product(const void* q, const void* w, int wtype, const void* npl,
                   const void* bnd, const void* bud, void* out, void* used,
                   int M, int K, int N, int n_bits, int D, int bm, int bn,
                   cudaStream_t s) {
  int slice = 0;
  const int splits = product_splits(M, K, N, &slice);
  const int tn = product_tn(N);
  const int col_tiles = (N + tn - 1) / tn;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(PT_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // no cluster when K is not split
  const QT* qq = static_cast<const QT*>(q);
  const int* np = static_cast<const int*>(npl);
  const int* bd = static_cast<const int*>(bnd);
  const int* bu = static_cast<const int*>(bud);
  float* o = static_cast<float*>(out);
  int* u = static_cast<int*>(used);
  const bool slab = col_tiles > 65535;
  auto kernel = tn == 16 ? (slab ? product_kernel<1, QT, true>
                                 : product_kernel<1, QT, false>)
                         : (slab ? product_kernel<4, QT, true>
                                 : product_kernel<4, QT, false>);
  for (int y0 = 0; y0 < col_tiles; y0 += 65535) {  // grid.y's limit
    const int ny = col_tiles - y0 < 65535 ? col_tiles - y0 : 65535;
    cfg.gridDim = dim3((M + PT_M - 1) / PT_M, ny, splits);
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, qq, w, wtype, np, bd,
                                         bu, o, u, M, K, N, n_bits, D, bm,
                                         bn, slice, y0);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Function attributes of a kernel, once per device (`done` holds a bit per
// device): the most shared memory per SM (so that small tiles keep many
// blocks) and the largest dynamic allocation a launch may ask for.
template <typename F>
cudaError_t smem_attributes(F* kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 32 || (done.load() >> dev & 1u)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
  if (err == cudaSuccess) done.fetch_or(1u << dev);
  return err;
}

template <int MI, int NI, typename QT, int NS, bool SLAB>
cudaError_t plane_attributes() {
  static std::atomic<unsigned> done{0};
  return smem_attributes(plane_kernel<MI, NI, QT, NS, SLAB>, done);
}

// Blocks of plane_kernel<MI, NI, QT> that fit on one SM at once, asked of
// the runtime once per device, block size and shared memory.
template <int MI, int NI, typename QT, int NS, bool SLAB>
cudaError_t blocks_per_sm(int threads, int smem, int* per_sm) {
  static std::mutex mu;
  static std::map<long long, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const long long key = (static_cast<long long>(dev) << 48) |
                        (static_cast<long long>(threads) << 32) | smem;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it == known.end()) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, plane_kernel<MI, NI, QT, NS, SLAB>, threads, smem);
    if (err != cudaSuccess) return err;
    it = known.emplace(key, n).first;
  }
  *per_sm = it->second;
  return cudaSuccess;
}

template <int MI, int NI, typename QT, int NS, bool SLAB>
int launch_plane_mn(const void* q, const void* w, int wtype, const float* sfx,
                    const float* tot, const int* npl, const int* bnd,
                    const int* bud, float* out, int* used, void* ws,
                    const void* parts, int M, int K, int N, int n_bits, int D,
                    int bm, int bn, int bk, int relu, PlaneGeom geo,
                    cudaStream_t s) {
  auto kernel = plane_kernel<MI, NI, QT, NS, SLAB>;
  cudaError_t err = plane_attributes<MI, NI, QT, NS, SLAB>();
  if (err != cudaSuccess) return err;
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(
      parts != nullptr ? parts : ws);
  if (!geo.resident && parts == nullptr) {  // W's parts, built for this call
    if (ws == nullptr) return cudaErrorInvalidValue;
    err = launch_split(w, wtype, wtype == W_F32 ? 3 : 1,
                       static_cast<__nv_bfloat16*>(ws), K, N, bn, geo.PN, s);
    if (err != cudaSuccess) return err;
  }
  const int threads = (geo.PM / (16 * MI)) * geo.WN * 32;
  const int Mt = M / bm;
  int per_sm = 0;
  if (geo.resident) {
    err = blocks_per_sm<MI, NI, QT, NS, SLAB>(threads, geo.smem, &per_sm);
    if (err != cudaSuccess) return err;
  }
  for (int y0 = 0; y0 < geo.Nt; y0 += 65535) {  // grid.y's limit
    const int ny = geo.Nt - y0 < 65535 ? geo.Nt - y0 : 65535;
    int gx = Mt;
    if (geo.resident) {  // as many blocks as fit at once, each over M tiles
      const long long fit = static_cast<long long>(per_sm > 1 ? per_sm : 1) *
                            NUM_SMS;
      const long long want = (fit + ny - 1) / ny;
      gx = static_cast<int>(want < Mt ? want : Mt);
    }
    geo.y0 = y0;
    kernel<<<dim3(gx, ny), threads, geo.smem, s>>>(
        static_cast<const QT*>(q), w, wtype, wp, sfx, tot, npl, bnd, bud, out,
        used, Mt, K, N, n_bits, D, bm, bn, bk, relu, geo);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

long long align16(long long x) { return (x + 15) / 16 * 16; }

// Warp tiles: (MI, NI) = (1, 1), (2, 2) or (4, 4) with the fewest rows per
// warp that keeps at most 16 warps (8 for 2 x 2 and 4 x 4, which need more
// registers).  A tile that none of these covers (128 x 24: 24 warps at
// (1, 1), and 24 columns rule out (2, 2) and (4, 4)) takes 8-column warp
// tiles of 2, 8 or 16 row fragments, the fewest that keep at most 16 warps,
// its physical rows rounded up to the warps' rows; it streams (the ReLU
// tiles of 8-bit signed q at 24 to 56 columns, block_m up to 128 and chunks
// of whole sub-chunks take the band kernel instead, launch_band's COLS 3;
// these tilings keep unsigned or wider q, block_k 16 or 32, block_m past
// 128 and the tiles without ReLU past 24 bits).  A tile that
// needs more than 16 warps even at 16 row fragments (ceil(bm / 256) *
// ceil(bn / 8) > 16, e.g. 1024 x 136) goes to launch_walk: mi = ni = 0.
// A tile of 8 columns whose q rows and W parts fit in
// RESIDENT_BYTES stays resident and builds its digits in registers, with
// 64 x 8 warp tiles when its rows are a multiple of 64 (the CNN conv: two
// warps per 128 x 8 tile).  Every other tile streams; its q rows over all of
// K are staged once where they fit beside the ring, else with each
// sub-chunk.  A staged q row is padded to 32 bytes past a multiple of 128,
// so that the four rows a warp decodes at once fall in distinct banks.
// Where NSTAGE ring stages of q and W sub-chunks overflow MAX_SMEM, a tall
// tiling's ring takes 2 stages (1024 x 24 at K = 1024: 250 KB), and a tile
// whose digit tile and 2 stages still overflow (block_m 2048 at 8 columns)
// goes to launch_walk.  So does a (4, 4) tile whose 3 stages overflow (448
// or 512 rows by 32 columns with int32 q past K = 64: 287 KB at 512 x 32),
// which one block of 8 warps would walk through a 2-stage ring alone:
// cluster_kernel spreads it over up to 16 blocks.  At their warp limits a
// (1, 1) or (2, 2) tile's 3 stages of int32 q and f32 parts take at most
// 146 KB.
template <typename QT>
int plane_geometry(int K, int N, int bm, int bn, int bk, int wtype,
                   PlaneGeom& geo, int& mi, int& ni) {
  geo.PM = (bm + 15) / 16 * 16;
  geo.PN = (bn + 7) / 8 * 8;
  mi = 0;
  for (int r = 1; r <= 4 && mi == 0; r *= 2)  // fewest rows a warp keeps
    if (geo.PM % (16 * r) == 0 && geo.PN % (8 * r) == 0 &&
        (geo.PM / (16 * r)) * (geo.PN / (8 * r)) <= (r == 1 ? 16 : 8))
      mi = r;
  ni = mi;
  if (mi != 0 && geo.PN == 8 && geo.PM % 64 == 0) mi = 4, ni = 1;
  const bool tall = mi == 0;  // 8-column warp tiles, streamed
  for (int r = 2; tall && r <= 16 && mi == 0; r *= (r == 2 ? 4 : 2)) {
    const int pm = (bm + 16 * r - 1) / (16 * r) * (16 * r);
    if ((pm / (16 * r)) * (geo.PN / 8) <= 16) mi = r, ni = 1, geo.PM = pm;
  }
  if (mi == 0) return cudaSuccess;  // launch_walk
  geo.WN = geo.PN / (8 * ni);
  geo.nstage = NSTAGE;
  geo.Nt = N / bn;

  const long long es = sizeof(QT);
  const long long parts = wtype == W_F32 ? 3 : 1;
  const long long T = static_cast<long long>(K / bk) * ((bk + KC - 1) / KC);
  const long long p_row = geo.PN + 8;
  const long long budgets = geo.PM * 4;
  const long long res_p = parts * T * KC * p_row * 2;
  const long long res_q = align16(static_cast<long long>(geo.PM) * K * es + 256);
  const long long res_bytes = budgets + res_p + 2 * res_q;
  if (!tall && geo.PN == 8 && res_bytes <= RESIDENT_BYTES) {
    geo.resident = 1;
    geo.p_part = static_cast<int>(T * KC * p_row);
    geo.q_bytes = static_cast<int>(res_q);
    geo.off_p = static_cast<int>(budgets);
    geo.off_q = static_cast<int>(budgets + res_p);
    geo.smem = static_cast<int>(res_bytes);
  } else {
    if (ni == 1 && mi == 4) mi = 1, ni = 1, geo.WN = 1;  // digit tile path
    geo.p_part = static_cast<int>(KC * p_row);
    geo.off_a = static_cast<int>(budgets);
    geo.off_q = static_cast<int>(budgets + geo.PM * AS * 2);
    const long long w_stage = parts * KC * p_row * 2;
    const long long once_stride = (K * es + 127) / 128 * 128 + 32;
    const long long once = geo.off_q + geo.PM * once_stride + NSTAGE * w_stage;
    const long long chunk_stride = align16(KC * es) + 16;
    const long long each =
        geo.off_q + NSTAGE * (geo.PM * chunk_stride + w_stage);
    geo.q_once = once <= MAX_SMEM;
    geo.q_stride = static_cast<int>(geo.q_once ? once_stride : chunk_stride);
    long long bytes = geo.q_once ? once : each;
    if (bytes > MAX_SMEM && tall) {
      geo.nstage = 2;  // a shallower ring
      bytes = geo.off_q + 2 * (geo.PM * chunk_stride + w_stage);
    }
    if (bytes > MAX_SMEM) {  // launch_walk
      mi = ni = 0;
      return cudaSuccess;
    }
    geo.smem = static_cast<int>(bytes);
  }
  return cudaSuccess;
}

// walk_kernel's sub-tiles: SC columns, at most WALK_WARPS * WALK_FRAGS
// fragments of 8, and as many rows as keep the sub-tile's fragments within
// that count, at most WALK_MAX_ROWS (16 x 512, 48 x 136, 336 x 24, 512 x 8).
template <typename QT>
WalkGeom walk_geometry(int N, int bm, int bn, int wtype) {
  constexpr int frags = WALK_WARPS * WALK_FRAGS;
  WalkGeom geo{};
  geo.PN = (bn + 7) / 8 * 8;
  geo.SC = geo.PN < 8 * frags ? geo.PN : 8 * frags;
  const int rows = frags / (geo.SC / 8) * 16;
  const int PM = (bm + 15) / 16 * 16;
  geo.SR = PM < rows ? PM : rows;
  if (geo.SR > WALK_MAX_ROWS) geo.SR = WALK_MAX_ROWS;
  geo.q_stride = static_cast<int>(align16(KC * sizeof(QT)) + 16);
  geo.p_row = geo.SC + 8;
  geo.p_part = KC * geo.p_row;
  geo.off_a = geo.SR * 4;
  geo.off_q = geo.off_a + geo.SR * AS * 2;
  geo.off_p = geo.off_q + geo.SR * geo.q_stride;
  geo.smem = geo.off_p + (wtype == W_F32 ? 3 : 1) * geo.p_part * 2;
  geo.Nt = N / bn;
  return geo;
}

// ---- E. cluster launcher

// cluster_kernel's warp tilings (MI, NI), in the order they are tried: the
// fewest fragments a warp first, so that a slice has the most warps to
// extract its digits.
constexpr int CL_TILINGS[4][2] = {{1, 1}, {2, 1}, {4, 1}, {4, 2}};

// A cluster of at most `blocks` blocks for one logical tile: for each
// tiling in turn, the fewest column groups (1, 2, 4, 8, 16; a group of at
// least 8 columns) whose slice fits CL_WARPS warps and the shared memory,
// each column group split in as many row groups of at least 16 * MI rows
// as the cluster holds.  Rows split first: blocks of one row group each
// extract the same digits.  Returns false (walk_kernel) where no cluster
// holds the tile's sums: 16 blocks of 16 warps of (4, 2) fragments, 1 MB
// of f32 sums (2048 x 256, or 4096 x 128), or a slice's shared memory
// past MAX_SMEM.  The choice reads the tile, K and the q type, never N.
template <typename QT>
bool cluster_geometry(int K, int bm, int bn, int bk, int wtype, int blocks,
                      ClusterGeom& geo, int& mi, int& ni) {
  const int PM = (bm + 15) / 16 * 16;
  const long long S = (bk + KC - 1) / KC;  // sub-chunks of a chunk
  const long long T = static_cast<long long>(K / bk) * S;
  geo.PN = (bn + 7) / 8 * 8;
  const long long es = sizeof(QT);
  const long long parts = wtype == W_F32 ? 3 : 1;
  for (int t = 0; t < 4; ++t) {
    const int MI_ = CL_TILINGS[t][0];
    const int NI_ = CL_TILINGS[t][1];
    for (int cgs = 1; cgs <= blocks && 8 * cgs <= geo.PN; cgs *= 2) {
      const int per = 8 * NI_;
      const int sc = (geo.PN + cgs * per - 1) / (cgs * per) * per;
      if ((cgs - 1) * sc >= geo.PN) continue;  // a group without columns
      int rgs = blocks / cgs;
      if (rgs > PM / (16 * MI_)) rgs = PM / (16 * MI_);
      if (rgs < 1) rgs = 1;
      const int rows = 16 * MI_;
      const int sr = (PM + rgs * rows - 1) / (rgs * rows) * rows;
      const int warps = sr / rows * (sc / per);
      if (warps > CL_WARPS) continue;
      const long long p_row = sc + 8;
      const long long budgets = 4LL * sr;
      const long long tile = 2LL * sr * AS;  // one digit tile
      const long long w_stage = parts * KC * p_row * 2;
      const long long once_stride = (K * es + 127) / 128 * 128 + 32;
      const long long chunk_stride = align16(KC * es) + 16;
      // resident: W over all of K and the q rows once, with as many digit
      // tiles as fit, up to a chunk's sub-chunks (at most 8)
      const long long w_all = parts * T * KC * p_row * 2;
      const long long fixed = budgets + sr * once_stride + w_all + 16;
      int dt = S < 8 ? S : 8;
      while (dt > 0 && fixed + dt * tile > MAX_SMEM) --dt;
      const long long once = budgets + tile + sr * once_stride +
                             NSTAGE * w_stage + 16;
      const bool q_once = dt > 0 || once <= MAX_SMEM;
      const long long bytes =
          dt > 0 ? fixed + dt * tile
                 : (q_once ? once
                           : budgets + tile +
                                 NSTAGE * (sr * chunk_stride + w_stage) + 16);
      if (bytes > MAX_SMEM) continue;
      geo.CL = rgs * cgs;
      geo.CG = cgs;
      geo.SR = sr;
      geo.SC = sc;
      geo.WN = sc / per;
      geo.resident = dt > 0 ? 1 : 0;
      geo.dt = dt > 0 ? dt : 1;
      geo.q_once = q_once ? 1 : 0;
      geo.q_stride = static_cast<int>(q_once ? once_stride : chunk_stride);
      geo.off_a = static_cast<int>(budgets);
      geo.off_q = static_cast<int>(budgets + geo.dt * tile);
      geo.off_p = geo.off_q + (q_once ? static_cast<int>(sr * once_stride)
                                      : 0);
      geo.p_row = static_cast<int>(p_row);
      geo.p_part = static_cast<int>((dt > 0 ? T : 1) * KC * p_row);
      geo.stage = static_cast<int>(q_once ? w_stage
                                          : sr * chunk_stride + w_stage);
      geo.off_vote = static_cast<int>(bytes - 16);
      geo.threads = warps * 32;
      geo.smem = static_cast<int>(bytes);
      mi = MI_, ni = NI_;
      return true;
    }
  }
  return false;
}

// The launch configuration of cluster_kernel<MI, NI, QT> for a geometry,
// and whether the card can hold one such cluster at once (asked of the
// runtime once per device, cluster size, block size and shared memory).
template <int MI, int NI, typename QT>
cudaError_t cluster_config(const ClusterGeom& geo, int gx, int ny,
                           cudaStream_t s, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute* attr, bool* fits) {
  static std::atomic<unsigned> done{0};
  static std::atomic<unsigned> wide{0};
  static std::mutex mu;
  static std::map<long long, int> known;
  auto kernel = cluster_kernel<MI, NI, QT>;
  cudaError_t err = smem_attributes(kernel, done);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && !(wide.load() >> dev & 1u)) {  // clusters of 9 to 16
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide.fetch_or(1u << dev);
  }
  cfg = {};
  cfg.gridDim = dim3(gx, ny);
  cfg.blockDim = dim3(geo.threads);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long key = (static_cast<long long>(dev) << 56) |
                        (static_cast<long long>(geo.CL) << 48) |
                        (static_cast<long long>(geo.threads) << 32) |
                        geo.smem;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it == known.end()) {
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    it = known.emplace(key, n).first;
  }
  *fits = it->second > 0;
  return cudaSuccess;
}

// The tile's cluster: 16 blocks where the card holds such a cluster, else
// 8 (a portable cluster).  `launch` false only chooses (the route query).
template <typename QT>
int launch_cluster(const void* q, int wtype, const float* sfx,
                   const float* tot, const int* npl, const int* bnd,
                   const int* bud, float* out, int* used,
                   const __nv_bfloat16* wp, int M, int K, int N, int n_bits,
                   int D, int bm, int bn, int bk, int relu, bool launch,
                   bool* taken, cudaStream_t s) {
  *taken = false;
  for (int blocks = CL_MAX_BLOCKS; blocks >= 8; blocks /= 2) {
    ClusterGeom geo{};
    int mi = 0, ni = 0;
    if (!cluster_geometry<QT>(K, bm, bn, bk, wtype, blocks, geo, mi, ni))
      return cudaSuccess;  // walk_kernel
    geo.Nt = N / bn;
    const int ny0 = geo.Nt < 65535 ? geo.Nt : 65535;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    bool fits = false;
    cudaError_t err = cudaErrorInvalidValue;
#define DSLOT_CLUSTER_CFG(MI_, NI_)                                          \
    if (mi == MI_ && ni == NI_)                                              \
      err = cluster_config<MI_, NI_, QT>(geo, M / bm * geo.CL, ny0, s, cfg,  \
                                         attr, &fits);
    DSLOT_CLUSTER_CFG(1, 1)
    DSLOT_CLUSTER_CFG(2, 1)
    DSLOT_CLUSTER_CFG(4, 1)
    DSLOT_CLUSTER_CFG(4, 2)
#undef DSLOT_CLUSTER_CFG
    if (err != cudaSuccess) return err;
    if (!fits && geo.CL > 8) continue;  // a cluster of 8 at most
    if (!fits) return cudaErrorInvalidValue;
    *taken = true;
    if (!launch) return cudaSuccess;
    for (int y0 = 0; y0 < geo.Nt; y0 += 65535) {  // grid.y's limit
      geo.y0 = y0;
      cfg.gridDim.y = geo.Nt - y0 < 65535 ? geo.Nt - y0 : 65535;
#define DSLOT_CLUSTER(MI_, NI_)                                              \
      if (mi == MI_ && ni == NI_)                                            \
        err = cudaLaunchKernelEx(&cfg, cluster_kernel<MI_, NI_, QT>,         \
                                 static_cast<const QT*>(q), wtype, wp, sfx,  \
                                 tot, npl, bnd, bud, out, used, K, N,        \
                                 n_bits, D, bm, bn, bk, relu, geo);
      DSLOT_CLUSTER(1, 1)
      DSLOT_CLUSTER(2, 1)
      DSLOT_CLUSTER(4, 1)
      DSLOT_CLUSTER(4, 2)
#undef DSLOT_CLUSTER
      if (err != cudaSuccess) return err;
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
  return cudaSuccess;
}

// The tiles no warp tiling of B takes: W's parts (prepared, or written for
// this call), then cluster_kernel where a cluster holds the tile, else
// walk_kernel.
template <typename QT>
int launch_walk(const void* q, const void* w, int wtype, const float* sfx,
                const float* tot, const int* npl, const int* bnd,
                const int* bud, float* out, int* used, void* ws,
                const void* parts, int M, int K, int N, int n_bits, int D,
                int bm, int bn, int bk, int relu, cudaStream_t s) {
  WalkGeom geo = walk_geometry<QT>(N, bm, bn, wtype);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(
      parts != nullptr ? parts : ws);
  if (parts == nullptr) {  // W's parts, built for this call
    if (ws == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err = launch_split(
        w, wtype, wtype == W_F32 ? 3 : 1, static_cast<__nv_bfloat16*>(ws), K,
        N, bn, geo.PN, s);
    if (err != cudaSuccess) return err;
  }
  bool taken = false;
  cudaError_t err = static_cast<cudaError_t>(launch_cluster<QT>(
      q, wtype, sfx, tot, npl, bnd, bud, out, used, wp, M, K, N, n_bits, D,
      bm, bn, bk, relu, true, &taken, s));
  if (err != cudaSuccess || taken) return err;
  static std::atomic<unsigned> done{0};
  err = smem_attributes(walk_kernel<QT>, done);
  if (err != cudaSuccess) return err;
  for (int y0 = 0; y0 < geo.Nt; y0 += 65535) {  // grid.y's limit
    const int ny = geo.Nt - y0 < 65535 ? geo.Nt - y0 : 65535;
    geo.y0 = y0;
    walk_kernel<QT><<<dim3(M / bm, ny), WALK_WARPS * 32, geo.smem, s>>>(
        static_cast<const QT*>(q), wtype, wp, sfx, tot, npl, bnd, bud, out,
        used, K, N, n_bits, D, bm, bn, bk, relu, geo);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Bytes of the streamed tiles' W parts (split_parts_kernel's layout).
long long parts_bytes(int K, int N, int bn, int PN, int wtype) {
  return (wtype == W_F32 ? 3LL : 1LL) * 2 * K * (N / bn) * PN;
}

// ---- D. band launcher

// The band kernel takes ReLU tiles of 8-bit signed q, 128 or 256 columns,
// block_m 16 to 128 and logical chunks of whole 64-row sub-chunks (the
// serving shapes, and the wide tiles a DslotConfig of block_n 256 gives);
// the narrow tiles of the port's launchers: 16, 32 or 64 columns,
// block_m 16 to 128 and chunks of whole sub-chunks, or block_m 16 to 64,
// chunks of 16 or 32 rows and K a multiple of 64; and 24, 40, 48 or 56
// columns, block_m 16 to 128 and chunks of whole sub-chunks.  q must suit TMA
// (16-byte aligned, K a multiple of 16 bytes).  What it takes depends on
// the tile and K alone, never on N, so a layer split over ranks by N tiles
// takes the same path on every rank.
int band_lbm(int bm) {
  return bm == 16 ? 4 : bm == 32 ? 5 : bm == 64 ? 6 : bm == 128 ? 7 : -1;
}

// The band kernel's vote for a tile (its COLS): 0 over a whole N tile of
// 128 or 256 columns, 1 per column tile of 16, 32 or 64 at the end of
// chunks of whole sub-chunks, 2 the same inside a sub-chunk (chunks of 16
// or 32 rows), 3 per column tile of 24, 40, 48 or 56 (chunks of whole
// sub-chunks); -1 for a tile it does not take.
int band_cols(int bn, int bk) {
  if (bn == 128 || bn == 256) return bk % BAND_KC == 0 ? 0 : -1;
  if (bn == 24 || bn == 40 || bn == 48 || bn == 56)
    return bk % BAND_KC == 0 ? 3 : -1;
  if (bn != 16 && bn != 32 && bn != 64) return -1;
  return bk % BAND_KC == 0 ? 1 : bk == 16 || bk == 32 ? 2 : -1;
}

bool band_path(const void* q, int M, int K, int bm, int bn, int bk,
               int n_bits, int relu) {
  const int cols = band_cols(bn, bk);
  const int band = cols == 2 ? 64 : BAND_ROWS;  // bands of 64 rows at COLS 2
  return relu && n_bits <= 8 && cols >= 0 && band_lbm(bm) > 0 &&
         bm <= band && K % BAND_KC == 0 &&
         (M + band - 1) / band <= 65535 &&
         (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

// Rows a band's products cover: the band's, or for a single band the
// fewest of 16, 32, 64 and 128 that hold its real rows (the rest are the
// wrapper's pad rows: zero digits, skipped).
int band_nb(int M, int m_real, int band) {
  if (M > band) return band;
  const int real = m_real > 0 && m_real < M ? m_real : M;
  return real <= 16 ? 16 : real <= 32 ? 32 : real <= 64 ? 64 : 128;
}

BandGeom band_geometry(int M, int K, int N, int n_bits, int D, int bm,
                       int bn, int bk, int parts, int nwg, int nb, int band) {
  BandGeom geo{};
  geo.Mp = M, geo.K = K, geo.N = N, geo.n_bits = n_bits, geo.D = D;
  geo.band = band;
  geo.bm = bm, geo.lbm = band_lbm(bm), geo.bk = bk, geo.parts = parts;
  geo.Nt = N / bn;
  geo.stage = (parts * nwg * BAND_BOX + nb * BAND_KC + 1023) / 1024 * 1024;
  geo.off_ring = 2 * nb * 128;
  const int rest = 64 + 4 * BAND_ROWS + 128;  // barriers, budgets, votes
  geo.ns = (MAX_SMEM - 1024 - geo.off_ring - rest) / geo.stage;
  if (geo.ns > BAND_MAX_STAGES) geo.ns = BAND_MAX_STAGES;
  geo.off_bar = geo.off_ring + geo.ns * geo.stage;
  geo.off_bud = geo.off_bar + 64;
  geo.off_vote = geo.off_bud + 4 * BAND_ROWS;
  geo.smem = 1024 + geo.off_vote + 128;
  return geo;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res{};
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &res) !=
        cudaSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &res) != cudaSuccess)
      f = nullptr;
#endif
    return res == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                              : nullptr;
  }();
  return fn;
}

// A 2-D row-major tensor map: rows x cols elements of `bytes` each, boxes of
// box_rows x box_cols.
bool tensor_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType ty,
                   int bytes, long long rows, long long cols, int box_rows,
                   int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, ty, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The parts' tensor map, once per (parts, K, N): the prepared parts of a
// layer live as long as the layer, and the map holds nothing else.  The
// band kernel's tiles (PN = bn) lay them out [part][K][N].
bool parts_map(CUtensorMap* map, const void* wp, int parts, int K, int N) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, CUtensorMap> known;
  const auto key = std::make_tuple(wp, parts, K, N);
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it == known.end()) {
    CUtensorMap m;
    if (!tensor_map_2d(&m, wp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                       static_cast<long long>(parts) * K, N, 64, 64,
                       CU_TENSOR_MAP_SWIZZLE_128B))
      return false;
    it = known.emplace(key, m).first;
  }
  *map = it->second;
  return true;
}

template <int NB, int NWG, bool CLUSTER, int COLS>
cudaError_t launch_band_nb(const CUtensorMap& tm_w, const CUtensorMap& tm_q,
                           const float* sfx, const float* tot, const int* npl,
                           const int* bnd, const int* bud, float* out,
                           int* used, const BandGeom& geo, int bands,
                           cudaStream_t s) {
  static std::atomic<unsigned> done{0};
  auto kernel = band_kernel<NB, NWG, CLUSTER, COLS>;
  cudaError_t err = smem_attributes(kernel, done);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  // narrow tiles: blocks of 64 * NWG columns (COLS 3: of the whole column
  // tiles they hold, bw), the last one partly past N
  const int bn = geo.N / geo.Nt;
  const int bw = COLS == 3 ? 64 * NWG / bn * bn : 64 * NWG;
  cfg.gridDim = dim3(COLS ? (geo.N + bw - 1) / bw : geo.Nt * (CLUSTER ? 2 : 1),
                     bands);
  cfg.blockDim = dim3(NWG * 128);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 2;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_w, tm_q, sfx, tot, npl, bnd, bud,
                           out, used, geo);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int launch_band(const void* q, const void* w, int wtype, const void* sfx,
                const void* tot, const void* npl, const void* bnd,
                const void* bud, void* out, void* used, void* ws,
                const void* parts, int n_parts, int m_real, int M, int K,
                int N, int n_bits, int D, int bm, int bn, int bk,
                cudaStream_t s) {
  const int cols = band_cols(bn, bk);
  const int Nt = (N + 127) / 128;  // 128-column units: the SM count
  int np = n_parts;
  const void* wp = parts;
  if (wp == nullptr) {  // W's parts, built for this call: [part][K][N]
    if (ws == nullptr) return cudaErrorInvalidValue;
    np = wtype == W_F32 ? 3 : 1;
    const int pn = cols == 0 ? 128 : bn;
    const cudaError_t err = launch_split(
        w, wtype, np, static_cast<__nv_bfloat16*>(ws), K, N, pn, pn, s);
    if (err != cudaSuccess) return err;
    wp = ws;
  }
  if (np != 1 && np != 3) return cudaErrorInvalidValue;
  // bands of 64 rows where bands of 128 would leave half the SMs idle
  // (the admission shapes of 32-64 N tiles) and block_m divides 64: twice
  // the blocks, each extracting and multiplying half the rows.  Votes
  // inside a sub-chunk (COLS 2) keep two sets of sums: always 64 rows.
  const int band = cols == 2 || (bm <= 64 && M > 64 &&
                                 2LL * ((M + BAND_ROWS - 1) / BAND_ROWS) *
                                         Nt <= NUM_SMS)
                       ? 64 : BAND_ROWS;
  const int bands = (M + band - 1) / band;
  int nb = band_nb(M, m_real, band);
  if (cols == 2 && nb == 32) nb = 64;  // COLS 2 builds bands of 16 and 64
  if (cols == 3 && nb < 64) nb = 64;   // COLS 3 bands of 64 and 128
  // a decode band (16 rows) whose tiles leave SMs idle: each N tile's
  // columns split over a 2-block cluster, one warpgroup a block (the same
  // sums, element for element), where the clusters fit on the SMs at once.
  // Wider bands keep one block a tile: both halves would extract the
  // band's digits, and a second wave costs more than the idle SMs.  A wide
  // tile (256 columns) always spans a 2-block cluster of two warpgroups
  // each, whose halves join their votes.
  // A narrow tile's 16-row band takes blocks of one warpgroup (64 columns)
  // with no cluster: its vote tiles lie within them.
  const bool wide = bn == 256;
  const bool split = cols == 0 && !wide && nb == 16 &&
                     2LL * bands * Nt <= NUM_SMS;
  const int nwg = split || (cols != 0 && nb == 16) ? 1 : 2;
  const BandGeom geo = band_geometry(M, K, N, n_bits, D, bm, bn, bk, np, nwg,
                                     nb, band);
  if (geo.ns < 2) return cudaErrorInvalidValue;
  CUtensorMap tm_w, tm_q;
  if (!parts_map(&tm_w, wp, np, K, N) ||
      !tensor_map_2d(&tm_q, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, nb,
                     BAND_KC, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const float* sf = static_cast<const float*>(sfx);
  const float* tt = static_cast<const float*>(tot);
  const int* pl = static_cast<const int*>(npl);
  const int* bd = static_cast<const int*>(bnd);
  const int* bu = static_cast<const int*>(bud);
  float* o = static_cast<float*>(out);
  int* u = static_cast<int*>(used);
#define DSLOT_BAND(NB_, NWG_, CLUSTER_, COLS_)                             \
  return launch_band_nb<NB_, NWG_, CLUSTER_, COLS_>(                      \
      tm_w, tm_q, sf, tt, pl, bd, bu, o, u, geo, bands, s);
  if (cols == 1) {
    if (nb == 16) DSLOT_BAND(16, 1, false, 1)
    if (nb == 32) DSLOT_BAND(32, 2, false, 1)
    if (nb == 64) DSLOT_BAND(64, 2, false, 1)
    if (nb == 128) DSLOT_BAND(128, 2, false, 1)
    return cudaErrorInvalidValue;
  }
  if (cols == 2) {
    if (nb == 16) DSLOT_BAND(16, 1, false, 2)
    if (nb == 64) DSLOT_BAND(64, 2, false, 2)
    return cudaErrorInvalidValue;
  }
  if (cols == 3) {
    if (nb == 64) DSLOT_BAND(64, 2, false, 3)
    if (nb == 128) DSLOT_BAND(128, 2, false, 3)
    return cudaErrorInvalidValue;
  }
  if (split) DSLOT_BAND(16, 1, true, 0)
  if (nb == 16 && !wide) DSLOT_BAND(16, 2, false, 0)
  if (nb == 16 && wide) DSLOT_BAND(16, 2, true, 0)
  if (nb == 32 && !wide) DSLOT_BAND(32, 2, false, 0)
  if (nb == 32 && wide) DSLOT_BAND(32, 2, true, 0)
  if (nb == 64 && !wide) DSLOT_BAND(64, 2, false, 0)
  if (nb == 64 && wide) DSLOT_BAND(64, 2, true, 0)
  if (nb == 128 && !wide) DSLOT_BAND(128, 2, false, 0)
  if (nb == 128 && wide) DSLOT_BAND(128, 2, true, 0)
#undef DSLOT_BAND
  return cudaErrorInvalidValue;
}

// The plane path.  Prepared parts (`parts`, n_parts of them) replace the
// per-call split_parts_kernel wherever a tile reads parts: the band kernel
// takes the serving shapes, every other streamed or walked tile reads them
// in place of its workspace.  One prepared part of f32 weights (bf16 holds
// every weight) is the layout bf16 weights give, so those tiles launch with
// W_BF16; a resident tile stages W from `w` itself and ignores them.
template <typename QT>
int launch_plane(const void* q, const void* w, int wtype, const void* sfx,
                 const void* tot, const void* npl, const void* bnd,
                 const void* bud, void* out, void* used, void* ws,
                 const void* parts, int n_parts, int m_real, int M, int K,
                 int N, int n_bits, int D, int bm, int bn, int bk, int relu,
                 cudaStream_t s) {
  if constexpr (std::is_same<QT, int8_t>::value) {
    if (band_path(q, M, K, bm, bn, bk, n_bits, relu))
      return launch_band(q, w, wtype, sfx, tot, npl, bnd, bud, out, used, ws,
                         parts, n_parts, m_real, M, K, N, n_bits, D, bm, bn,
                         bk, s);
  }
  PlaneGeom geo{};
  int mi = 0, ni = 0;
  int err = plane_geometry<QT>(K, N, bm, bn, bk, wtype, geo, mi, ni);
  if (err != cudaSuccess) return err;
  if (parts != nullptr && (mi != 0 && geo.resident)) parts = nullptr;
  if (parts != nullptr && n_parts == 1 && wtype == W_F32) {
    PlaneGeom one{};
    int mi1 = 0, ni1 = 0;
    err = plane_geometry<QT>(K, N, bm, bn, bk, W_BF16, one, mi1, ni1);
    if (err != cudaSuccess) return err;
    if (mi1 == 0 || !one.resident) {
      geo = one, mi = mi1, ni = ni1;
      wtype = W_BF16;
    } else {
      parts = nullptr;
    }
  }
  const float* sf = static_cast<const float*>(sfx);
  const float* tt = static_cast<const float*>(tot);
  const int* np = static_cast<const int*>(npl);
  const int* bd = static_cast<const int*>(bnd);
  const int* bu = static_cast<const int*>(bud);
  float* o = static_cast<float*>(out);
  int* u = static_cast<int*>(used);
  // The warp tiles that ran before slabs keep a variant with their old code
  // for up to 65535 N tiles; every other launch takes the SLAB variant.
  if (mi == 0)
    return launch_walk<QT>(q, w, wtype, sf, tt, np, bd, bu, o, u, ws, parts,
                           M, K, N, n_bits, D, bm, bn, bk, relu, s);
  const bool slab = geo.Nt > 65535;
#define DSLOT_PLANE(MI_, NI_, NS_, SLAB_)                                   \
  if (mi == MI_ && ni == NI_ && geo.nstage == NS_ && (SLAB_ || !slab))      \
    return launch_plane_mn<MI_, NI_, QT, NS_, SLAB_>(                       \
        q, w, wtype, sf, tt, np, bd, bu, o, u, ws, parts, M, K, N, n_bits, \
        D, bm, bn, bk, relu, geo, s);
  DSLOT_PLANE(1, 1, NSTAGE, false)
  DSLOT_PLANE(2, 2, NSTAGE, false)
  DSLOT_PLANE(4, 4, NSTAGE, false)
  DSLOT_PLANE(4, 1, NSTAGE, false)
  DSLOT_PLANE(1, 1, NSTAGE, true)
  DSLOT_PLANE(2, 2, NSTAGE, true)
  DSLOT_PLANE(4, 4, NSTAGE, true)
  DSLOT_PLANE(4, 1, NSTAGE, true)
  DSLOT_PLANE(2, 1, NSTAGE, true)
  DSLOT_PLANE(8, 1, NSTAGE, true)
  DSLOT_PLANE(16, 1, NSTAGE, true)
  DSLOT_PLANE(8, 1, 2, true)
  DSLOT_PLANE(16, 1, 2, true)
#undef DSLOT_PLANE
  return cudaErrorInvalidValue;
}

template <typename QT>
int launch_typed(const void* q, int wtype, const void* w, const void* sfx,
                 const void* tot, const void* npl, const void* bnd,
                 const void* bud, void* out, void* used, void* ws,
                 const void* parts, int n_parts, int m_real, int M, int K,
                 int N, int n_bits, int D, int bm, int bn, int bk, int relu,
                 cudaStream_t s) {
  if (product_path(n_bits, relu))
    return launch_product<QT>(q, w, wtype, npl, bnd, bud, out, used, M, K, N,
                              n_bits, D, bm, bn, s);
  return launch_plane<QT>(q, w, wtype, sfx, tot, npl, bnd, bud, out, used, ws,
                          parts, n_parts, m_real, M, K, N, n_bits, D, bm, bn,
                          bk, relu, s);
}

}  // namespace

extern "C" {

// Bytes of scratch a launch with these arguments needs, for the wrapper to
// allocate: the bf16 parts of W for tiles that stream it (0 for the product
// path and for resident tiles), or -1 for a shape the kernel does not take.
long long dslot_matmul_workspace(int K, int N, int bm, int bn, int bk,
                                 int n_bits, int relu, int qtype, int wtype) {
  if (K <= 0 || N <= 0 || bm <= 0 || bn <= 0 || bk <= 0 || N % bn != 0 ||
      K % bk != 0 || wtype < W_F32 || wtype > W_BF16)
    return -1;
  if (product_path(n_bits, relu)) return 0;
  PlaneGeom geo{};
  int mi = 0, ni = 0, err = cudaErrorInvalidValue;
#define DSLOT_GEOM(CODE, T) \
  if (qtype == CODE) err = plane_geometry<T>(K, N, bm, bn, bk, wtype, geo, mi, ni);
  DSLOT_GEOM(Q_U8, uint8_t)
  DSLOT_GEOM(Q_I8, int8_t)
  DSLOT_GEOM(Q_U16, uint16_t)
  DSLOT_GEOM(Q_I16, int16_t)
  DSLOT_GEOM(Q_I32, int32_t)
#undef DSLOT_GEOM
  if (err != cudaSuccess) return -1;
  return geo.resident ? 0 : parts_bytes(K, N, bn, geo.PN, wtype);
}

// One launch's arguments, every field 8 bytes, so that the caller packs them
// in one step (25 int64 in this order).
struct DslotArgs {
  const void* q;
  long long qtype;
  const void* w;
  long long wtype;
  const void* sfx;
  const void* tot;
  const void* npl;
  const void* bnd;
  const void* bud;   // null: every row takes all planes
  void* out;
  void* used;
  void* ws;          // dslot_matmul_workspace bytes, or null when 0
  long long M, K, N, n_bits, D, bm, bn, bk, relu;
  void* stream;
  const void* parts;  // W's prepared bf16 parts (dslot_split_parts), or null
  long long n_parts;  // how many: 1 or 3 (0 with no parts)
  long long m_real;   // rows before the caller's padding (M when unpadded)
};

// Returns a cudaError_t as int: cudaErrorInvalidValue for shapes the kernel
// does not take, else cudaGetLastError() right after the launches.
int dslot_matmul_launch(const DslotArgs* a) {
  if (a->M <= 0 || a->N <= 0 || a->K <= 0 || a->bm <= 0 || a->bn <= 0 ||
      a->bk <= 0 || a->M > INT_MAX || a->N > INT_MAX || a->K > INT_MAX ||
      a->M % a->bm != 0 || a->N % a->bn != 0 || a->K % a->bk != 0 ||
      a->D < 1 || a->D > a->n_bits || a->n_bits > 30 || a->qtype < Q_U8 ||
      a->qtype > Q_I32 || a->wtype < W_F32 || a->wtype > W_BF16 ||
      (a->parts != nullptr && a->n_parts != 1 && a->n_parts != 3) ||
      (a->parts != nullptr && a->n_parts == 3 && a->wtype != W_F32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = static_cast<int>(a->M), K = static_cast<int>(a->K),
            N = static_cast<int>(a->N), n_bits = static_cast<int>(a->n_bits),
            D = static_cast<int>(a->D), bm = static_cast<int>(a->bm),
            bn = static_cast<int>(a->bn), bk = static_cast<int>(a->bk),
            relu = static_cast<int>(a->relu), wtype = static_cast<int>(a->wtype);
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
#define DSLOT_TYPED(CODE, T)                                                 \
  if (a->qtype == CODE)                                                      \
    return launch_typed<T>(a->q, wtype, a->w, a->sfx, a->tot, a->npl, a->bnd,\
                           a->bud, a->out, a->used, a->ws, a->parts,       \
                           static_cast<int>(a->n_parts),                     \
                           static_cast<int>(a->m_real), M, K, N, n_bits, D,  \
                           bm, bn, bk, relu, s);
  DSLOT_TYPED(Q_U8, uint8_t)
  DSLOT_TYPED(Q_I8, int8_t)
  DSLOT_TYPED(Q_U16, uint16_t)
  DSLOT_TYPED(Q_I16, int16_t)
  DSLOT_TYPED(Q_I32, int32_t)
#undef DSLOT_TYPED
  return static_cast<int>(cudaErrorInvalidValue);
}

// W's n_parts bf16 parts in split_parts_kernel's layout [part][K][N / bn]
// [PN], PN = bn rounded up to 8, from f32 or bf16 weights in one launch: 3
// parts, or 1 (bf16(w), exact where bf16 holds every weight).  Run once per
// layer, when it is prepared.
int dslot_split_parts(const void* w, int wtype, int n_parts, void* out,
                      int K, int N, int bn, void* stream) {
  if (K <= 0 || N <= 0 || bn <= 0 || N % bn != 0 || wtype < W_F32 ||
      wtype > W_BF16 || (n_parts != 1 && n_parts != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_split(
      w, wtype, n_parts, static_cast<__nv_bfloat16*>(out), K, N, bn,
      (bn + 7) / 8 * 8, static_cast<cudaStream_t>(stream)));
}

// The kernel a launch with these arguments takes (q 16-byte aligned, as
// torch allocates it, and no prepared parts): 0 product_kernel, 1
// plane_kernel, 2 band_kernel, 3 cluster_kernel, 4 walk_kernel, or -1 for a
// shape the kernel does not take.  Asks the card whether a cluster fits.
int dslot_matmul_route(int M, int K, int N, int bm, int bn, int bk,
                       int n_bits, int relu, int qtype, int wtype) {
  if (dslot_matmul_workspace(K, N, bm, bn, bk, n_bits, relu, qtype, wtype) <
          0 || M <= 0 || M % bm != 0)
    return -1;
  if (product_path(n_bits, relu)) return 0;
  if (qtype == Q_I8 && band_path(nullptr, M, K, bm, bn, bk, n_bits, relu))
    return 2;
  int route = -1;
#define DSLOT_ROUTE(CODE, T)                                                \
  if (qtype == CODE) {                                                      \
    PlaneGeom geo{};                                                        \
    int mi = 0, ni = 0;                                                     \
    plane_geometry<T>(K, N, bm, bn, bk, wtype, geo, mi, ni);                \
    bool taken = false;                                                     \
    if (mi != 0)                                                            \
      route = 1;                                                            \
    else if (launch_cluster<T>(nullptr, wtype, nullptr, nullptr, nullptr,   \
                               nullptr, nullptr, nullptr, nullptr, nullptr, \
                               M, K, N, n_bits, n_bits, bm, bn, bk, relu,   \
                               false, &taken, 0) == cudaSuccess)            \
      route = taken ? 3 : 4;                                                \
  }
  DSLOT_ROUTE(Q_U8, uint8_t)
  DSLOT_ROUTE(Q_I8, int8_t)
  DSLOT_ROUTE(Q_U16, uint16_t)
  DSLOT_ROUTE(Q_I16, int16_t)
  DSLOT_ROUTE(Q_I32, int32_t)
#undef DSLOT_ROUTE
  return route;
}

const char* dslot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Chunked SSD forward and backward at bf16 on Hopper's warpgroup tensor
// cores: K8 (lean, with the states entering each chunk, with the state after
// the last, h_fin) and K9 (its dh carry from 0 or seeded with dh_fin) at
// d_state = head_dim = 128 and every chunk that is a multiple of 64 from 64
// to 256, the shapes of the bf16 SSD presets
// (cfgs/finetune_modelnet_ssd_fused.yaml: chunk 256;
// cfgs/pretrain_ssd_fused.yaml: chunk 128). They replace, at those shapes and
// at bf16, the TPU kernels `_make_fwd_kernel_xbc`
// (si_mamba_tpu/ops/pallas/ssd_kernel.py:540, behind `_fwd_call_xbc`,
// `pallas_call` at :602) and `_make_bwd_kernel_xbc` (:623, `_bwd_head` :241,
// behind `_bwd_call_xbc`, `pallas_call` at :698); the other shapes, and
// K6/K7, stay on the chunk-parallel bodies of csrc/ssd_xbc_fwd.cu and
// csrc/ssd_xbc_bwd.cu (ops/kernels/ssd.py:kernel_variant picks the body
// before the launch). The maths and every rounding point are those bodies'
// at bf16 (their headers list them): K8: G = C B^T in fp32 from bf16
// products; bf16(G (.) M) bf16(x dt); e^S (C bf16(h_in)); B^T bf16(bf16(x dt)
// e^{S_end - S}); K9: bf16 products for G, bf16(GM)^T dy, dy bf16(x dt)^T and
// dy bf16(h_in)^T; 3xTF32 (hi + lo split, the lo-lo term dropped) for B dh,
// (bf16(x dt) dh^T) T_end, the carry (C E)^T dy and dG B, dG^T C on the head
// sum of bf16(dG); the states, decays, ddt, dS and dD fp32; every sum across
// heads, tiles or blocks in a fixed order, no atomics (two runs bitwise
// equal). dE, the row sums of dy bf16(h_in)^T (.) C, comes as two sums over
// the halves of n whatever the blocks of bwd_dbc, so that its order, and dS,
// do not depend on the batch or the card.
//
// Bound on the H100 at B=32, L=512, chunk 256, 6 heads (the finetune preset):
// K8 moves about 84 MB with h_in (0.025 ms at 3.35 TB/s) for 7.0 GFLOP of bf16
// products (0.007 ms at 989 TFLOP/s); K9 needs 8.62 GFLOP of bf16 products and
// 5.91 of 3xTF32 ones (three TF32 products each at 495: 0.045 ms in all)
// against about 211 MB (0.063 ms).
//
// What held the chunk-parallel body back at bf16 (PERF.md §6), and what this
// body does about it:
//  1. Warp-level mma.sync fed fragment by fragment. Here every product is a
//     warpgroup wgmma.mma_async (csrc/wgmma.cuh): m64nNk16 bf16 with both
//     operands in shared memory, or A in registers; m64nNk8 tf32 with A in
//     registers (split there as hi + lo) and B in shared memory.
//  2. G and dG through fp32 scratch in device memory. Here G (fwd_y,
//     bwd_dgm) and G^T (bwd_dx) of each 64 x 64 tile pair are taken where
//     they are needed and stay in registers: masked, decayed and rounded to
//     bf16 there, the accumulator is the register A of the next product (G
//     (.) M with x dt, as attention kernels feed P V). Only the head sum of
//     bf16(dG) still goes through device memory (bwd_dgm to bwd_dbc).
//  3. The chunk carry as a separate pass. Here fwd_state (bwd_state for dh)
//     keeps it in the accumulators of one block a (b, h), a warpgroup a
//     64-row half of n, walking the chunks in order (in reverse for dh).
//  4. One block a (b, chunk, strip, head), each reading its own copy of the
//     shared operands. Here fwd_y and bwd_dx run one block a (b, chunk,
//     head) with a warpgroup a strip (up to 4), which share every tile they
//     read; bwd_dbc shapes its blocks by the card's SM count.
//  5. Loads by every thread, 16 bytes at a time, into padded tiles, two
//     stages. Here every tile that lands as it is in device memory (xbc's
//     and dy's rows, bf16 h_in, dh) is one request of one thread to the
//     tensor memory accelerator (csrc/tma.cuh), into the 128-byte swizzled
//     layout wgmma reads (and that the threads read without bank
//     conflicts), its arrival counted on an mbarrier, in rings of three or
//     four stages (two in fwd_y and bwd_dx at two strips, where the ring
//     holds every tile of the chunk). The threads only transform what needs
//     arithmetic first, in place (bf16(x dt) and its decayed twin, the hi +
//     lo split of dh), or into the layouts the tf32 products need (the
//     transposed dy^T, dh^T, B^T, C^T). The block barrier that orders those
//     transforms also says when a stage is free again: the thread that
//     issues the copies needs no barrier of its own, and no producer warp
//     takes registers from the warpgroups.
// K8 is two launches (fwd_state, fwd_y); K9 five (bwd_state, bwd_dgm,
// bwd_dx, bwd_dbc, bwd_ds), bwd_state left out where no chunk has a dh.
// xbc and dy reach the copies through tensor maps, so their base and row
// and batch strides are 16-byte aligned (the wrappers copy a view that is
// not).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using wg::Shape;

constexpr int kThreads = 128;  // a warpgroup
constexpr int kN = 128;        // d_state
constexpr int kP = 128;        // head_dim
constexpr int kS = 64;         // rows of a strip: a product's M
constexpr int kMaxChunk = 256;

// The block's dynamic shared memory from its first 1024-byte boundary, where
// swizzled tiles start (each kernel asks for 1024 bytes more).
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return smem_raw + ((1024 - (tma::smem(smem_raw) & 1023)) & 1023);
}

__device__ __forceinline__ float lo16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return uint4{wg::pack(v[0], v[1]), wg::pack(v[2], v[3]), wg::pack(v[4], v[5]),
               wg::pack(v[6], v[7])};
}

// The barriers of n stages, each armed by one thread, then visible to the
// copies and to every thread.
__device__ __forceinline__ void init_bars(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) tma::init(bars + i, 1);
    tma::fence_init();
  }
  __syncthreads();
}

// The R-row, 128-column bf16 block at (column col, row, batch b) of a map
// with R-row boxes into the tile t: two 64-column boxes, an atom each.
template <int R>
__device__ __forceinline__ void load128(bf16* t, const CUtensorMap* map, uint64_t* bar, int col,
                                        int row, int b) {
  tma::load(t, map, bar, col, row, b);
  tma::load(t + R * 64, map, bar, col + 64, row, b);
}

// The staging loops below take NT threads (the block's).
// Every element of a 128-byte swizzled bf16 tile (kAtoms atoms of R rows)
// rewritten in place as fx(row, v) and rounded to bf16, a 16-byte chunk a
// thread at a time. Every transform here depends on the row only, which the
// swizzle leaves in place.
template <int R, int kAtoms, int NT, class Fx>
__device__ __forceinline__ void xform_rows(bf16* tile, Fx fx) {
#pragma unroll
  for (int u = threadIdx.x; u < R * 8 * kAtoms; u += NT) {
    const int row = (u >> 3) % R;
    uint4* at = reinterpret_cast<uint4*>(tile) + u;
    const uint4 q = *at;
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[2 * j] = fx(row, lo16(w[j])), v[2 * j + 1] = fx(row, hi16(w[j]));
    *at = pack8(v);
  }
}

// The tf32 tile (K-major, unswizzled, N extent W) of the transpose of a
// swizzled bf16 tile src of K rows and W columns (atoms of K rows): element
// (n, k) = src(k, n), widened. Each thread takes 4 consecutive rows of one
// column and writes their 16-byte core-matrix row; a warp's 32 lanes take 32
// consecutive columns.
template <int K, int W, int NT>
__device__ __forceinline__ void to_tf32_t(float* tile, const bf16* src) {
#pragma unroll
  for (int i = threadIdx.x; i < (K / 4) * W; i += NT) {
    const int n = i % W, k = i / W * 4;
    *reinterpret_cast<float4*>(tile + wg::tf32_at(n, k, W)) =
        make_float4(f(src[tma::at16(k, n, K)]), f(src[tma::at16(k + 1, n, K)]),
                    f(src[tma::at16(k + 2, n, K)]), f(src[tma::at16(k + 3, n, K)]));
  }
}

// An fp32 tile of R x K floats split in place into its tf32 hi part and, at
// the same offsets of lo, its lo part, a 16-byte chunk a thread (any layout).
template <int R, int K, int NT>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
#pragma unroll
  for (int i = threadIdx.x; i < R * K / 4; i += NT) {
    float4* at = reinterpret_cast<float4*>(hi) + i;
    const float4 v = *at;
    uint32_t h[4], l[4];
    wg::split_tf32(v.x, h[0], l[0]);
    wg::split_tf32(v.y, h[1], l[1]);
    wg::split_tf32(v.z, h[2], l[2]);
    wg::split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(at) = uint4{h[0], h[1], h[2], h[3]};
    reinterpret_cast<uint4*>(lo)[i] = uint4{l[0], l[1], l[2], l[3]};
  }
}

// The writes to a tile by the threads are visible to every thread and to the
// tensor cores and the copies; every read of the block's earlier stages is
// done.
__device__ __forceinline__ void written() {
  wg::fence_async();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// registers

// Keep the compiler from moving reads or writes of these registers across
// the wgmma issue and wait around them.
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void keep(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// The sums over the columns of v(r, d[r]) for the thread's two rows (half 0:
// wg::acc_row(0), half 1: 8 rows on), over the accumulator elements e0 .. e1
// - 1, the same in the 4 threads of a quad, in a fixed order: the thread's
// elements in turn, then the quad.
template <int R, class V>
__device__ __forceinline__ void row_sums(const float (&d)[R], V v, float (&out)[2], int e0 = 0,
                                         int e1 = R) {
  out[0] = out[1] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r >= e0 && r < e1) out[(r & 3) >> 1] += v(r, d[r]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    out[h] += __shfl_xor_sync(0xffffffffu, out[h], 1);
    out[h] += __shfl_xor_sync(0xffffffffu, out[h], 2);
  }
}

// out[c] = the sum over the 64 rows of column c of a 64 x 64 accumulator, in
// a fixed order: the warp's 16 rows by shuffles, then the 4 warps in turn
// through red (4 x 64 floats). Ends synchronised.
__device__ __forceinline__ void col_sums64(const float (&d)[32], float* red, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = d[4 * j + e] + d[4 * j + 2 + e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      s[2 * j + e] = v;
    }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[warp * 64 + 8 * j + 2 * lane + e] = s[2 * j + e];
  }
  __syncthreads();
  if (threadIdx.x < 64)
    out[threadIdx.x] = ((red[threadIdx.x] + red[64 + threadIdx.x]) + red[128 + threadIdx.x]) +
                       red[192 + threadIdx.x];
  __syncthreads();
}

// The sum of v over each warpgroup of the block, the same in its every
// thread, in a fixed order; every thread of the block takes part. red: 4
// floats a warpgroup.
__device__ __forceinline__ float wg_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const float* r = red + (threadIdx.x >> 7) * 4;
  const float total = ((r[0] + r[1]) + r[2]) + r[3];
  __syncthreads();
  return total;
}

// ---------------------------------------------------------------------------
// forward (K8)

// The operands and outputs of one forward. mx: xbc (b, L, d + 2n) bf16 in
// 64 x 64 boxes; mh16: hin16 in boxes of 64 columns and 128 rows (nc > 1).
// xbc with batch and row strides sb, sr; dt, S (b, h, L) fp32; Dp (h); y
// (b, L, d) bf16 contiguous; hin the slots slot0 .. nc - 1 of the states
// entering each chunk, (b, nc - slot0, h, n, p) fp32: h_in itself (slot0 0)
// or the lean forward's scratch (slot0 1); hin16 the states entering chunks
// 1 .. nc - 1 rounded to bf16, (b, nc - 1, h, n, p), the operand of C
// bf16(h_in); hfin (b, h, n, p) fp32 the state after the last chunk, or null.
struct Fwd {
  CUtensorMap mx, mh16;
  const bf16* xbc;
  long long sb, sr;
  const float* dt;
  const float* S;
  const float* Dp;
  bf16* y;
  float* hin;
  bf16* hin16;
  float* hfin;
  int B, L, H, Q, d, slot0;
};

__device__ __forceinline__ float* slot(const Fwd& a, int b, int c, int h) {
  const int held = a.L / a.Q - a.slot0;
  return a.hin + ((static_cast<long long>(b) * held + c - a.slot0) * a.H + h) * (kN * kP);
}

// hin16's row of the state entering chunk c >= 1 (kN rows a state)
__device__ __forceinline__ int row16(const Fwd& a, int b, int c, int h) {
  return ((b * (a.L / a.Q - 1) + c - 1) * a.H + h) * kN;
}

// Per (b, h), one warpgroup a 64-row half of the state's n: the states
// entering chunks 1 .. nc - 1 (and with kFin the state after the last),
// h_in[c + 1] = e^{S_end[c]} h_in[c] + B_c^T bf16(bf16(x dt) e^{S_end - S}),
// the carry kept in the accumulator from chunk to chunk, in 64-row slabs of
// the chunk: A = B^T (MN-major: B's slab lands as its two 64-column atoms,
// one a half), B = the decayed bf16(x dt) (MN-major, shared), three stages.
// With kStates it also zeroes h_in[0].
constexpr int kStateStages = 3;
constexpr int kStateStage = kS * kN + kS * kP;  // bf16 elements: B's slab, x's

template <bool kStates, bool kFin>
__global__ void __launch_bounds__(2 * kThreads, 2) fwd_state(const __grid_constant__ Fwd a) {
  constexpr int NT = 2 * kThreads, S = kStateStages;
  __shared__ __align__(8) uint64_t full[S];
  __shared__ float arr[S][2 * kS];  // a stage's dt and e^{S_end - S}
  bf16* ring = reinterpret_cast<bf16*>(smem_base());
  const int half = threadIdx.x >> 7, h = blockIdx.x % a.H, b = blockIdx.x / a.H;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const int nc = a.L / a.Q, spc = a.Q / kS, slabs = (kFin ? nc : nc - 1) * spc;
  if (kStates) {
    float* z = slot(a, b, 0, h);
    for (int i = threadIdx.x; i < kN * kP / 4; i += NT)
      reinterpret_cast<float4*>(z)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (slabs == 0) return;
  auto issue = [&](int i) {  // slab i into stage i % S: B's rows and x's, raw
    const int row = i / spc * a.Q + i % spc * kS;
    bf16* st = ring + (i % S) * kStateStage;
    tma::expect(&full[i % S], kStateStage * 2);
    load128<kS>(st, &a.mx, &full[i % S], a.d, row, b);
    load128<kS>(st + kS * kN, &a.mx, &full[i % S], h * kP, row, b);
  };
  auto arrays = [&](int i) {  // the threads below kS: slab i's dt and decay
    const float* Sc = a.S + bh * a.L + static_cast<long long>(i / spc) * a.Q;
    const int t = i % spc * kS + threadIdx.x;
    arr[i % S][threadIdx.x] = a.dt[bh * a.L + static_cast<long long>(i / spc) * a.Q + t];
    arr[i % S][kS + threadIdx.x] = expf(Sc[a.Q - 1] - Sc[t]);
  };
  init_bars(full, S);
  for (int i = 0; i < S && i < slabs; ++i) {
    if (threadIdx.x == 0) issue(i);
    if (threadIdx.x < kS) arrays(i);
  }
  __syncthreads();
  float acc[64];
  zero(acc);
  for (int i = 0; i < slabs; ++i) {
    const int c = i / spc, j = i % spc;
    tma::wait(&full[i % S], (i / S) & 1);
    if (j == 0 && c > 0) {  // acc holds h_in[c]: decay it across chunk c
      const float decay = expf(a.S[bh * a.L + static_cast<long long>(c + 1) * a.Q - 1]);
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] *= decay;
    }
    bf16* st = ring + (i % S) * kStateStage;
    const float* fs = arr[i % S];
    xform_rows<kS, 2, NT>(st + kS * kN, [=](int s, float v) { return rbf(v * fs[s]) * fs[kS + s]; });
    written();
    if (i >= 1 && i + S - 1 < slabs) {  // into the stage slab i - 1 left
      if (threadIdx.x == 0) issue(i + S - 1);
      if (threadIdx.x < kS) arrays(i + S - 1);
    }
    keep(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kS / 16; ++kk)
      wg::mma_ss<1, 1>(acc, tma::mndesc(st + half * kS * 64, kS, kk),
                       tma::mndesc(st + kS * kN, kS, kk), 1, Shape<128>{});
    wg::commit();
    wg::wait<0>();
    keep(acc);
    if (j == spc - 1) {
      const int at0 = half * 64 * kP;
      if (kFin && c == nc - 1) {  // h_fin
        float* dst = a.hfin + bh * (kN * kP) + at0;
#pragma unroll
        for (int r = 0; r < 64; r += 2)
          *reinterpret_cast<float2*>(dst + wg::acc_row(r) * kP + wg::acc_col(r)) =
              make_float2(acc[r], acc[r + 1]);
      } else {  // h_in[c + 1], and its bf16 copy
        float* dst = slot(a, b, c + 1, h) + at0;
        bf16* dst16 = a.hin16 + static_cast<long long>(row16(a, b, c + 1, h)) * kP + at0;
#pragma unroll
        for (int r = 0; r < 64; r += 2) {
          const int at = wg::acc_row(r) * kP + wg::acc_col(r);
          *reinterpret_cast<float2*>(dst + at) = make_float2(acc[r], acc[r + 1]);
          *reinterpret_cast<uint32_t*>(dst16 + at) = wg::pack(acc[r], acc[r + 1]);
        }
      }
    }
  }
}

// Per (b, chunk, head), one warpgroup a 64-row strip t of the chunk (kT of
// them, chunk = 64 kT): y = e^S (C bf16(h_in)) + the sum over the s tiles up
// to the strip of bf16(G (.) M) bf16(x dt) + D x, with G = C B^T of each
// 64 x 64 tile pair taken on the tensor cores and kept in registers, masked
// and decayed there and fed as the register A of the product with x dt (no
// G in device memory). The warpgroups share what they read: h_in's tile and
// each s tile of B and x land once a block (the strips from the tile's on
// take it). Shared memory: C's strips (K-major), a ring of y_stages {B's s
// tile (K-major), x's (MN-major, then bf16(x dt) in place)}, its last stage
// first holding bf16(h_in) (MN-major).
constexpr int kYStrip = kS * kN;            // bf16 elements: C's strip
constexpr int kYStage = kS * kN + kS * kP;  // B's s tile, x's

// the stages of fwd_y's and bwd_dx's rings at kT strips: three, or all the
// tiles of a chunk of two strips (the smaller shared memory keeps two blocks
// an SM)
__host__ __device__ constexpr int y_stages(int kT) { return kT >= 3 ? 3 : 2; }
// blocks an SM the register budget leaves room for, by warpgroups a block
__host__ __device__ constexpr int min_blocks(int warpgroups) { return warpgroups == 1 ? 3 : warpgroups == 2 ? 2 : 1; }

template <int kT>
__global__ void __launch_bounds__(kT * kThreads, min_blocks(kT)) fwd_y(const __grid_constant__ Fwd a) {
  constexpr int NT = kT * kThreads, S = y_stages(kT);
  __shared__ __align__(8) uint64_t bars[S + 1];  // the stages', then C's and h_in's
  __shared__ float sS[kMaxChunk], sdt[kMaxChunk];
  bf16* sC = reinterpret_cast<bf16*>(smem_base());
  bf16* ring = sC + kT * kYStrip;
  bf16* sH = ring + (S - 1) * kYStage;
  const int nc = a.L / a.Q, w = threadIdx.x >> 7;  // w: this warpgroup's strip
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H % nc, b = blockIdx.x / a.H / nc;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const int r0 = c * a.Q, t0 = w * kS;
  auto issue = [&](int si) {  // B's s tile and x's, raw
    bf16* st = ring + (si % S) * kYStage;
    tma::expect(&bars[si % S], kYStage * 2);
    load128<kS>(st, &a.mx, &bars[si % S], a.d, r0 + si * kS, b);
    load128<kS>(st + kS * kN, &a.mx, &bars[si % S], h * kP, r0 + si * kS, b);
  };
  init_bars(bars, S + 1);
  if (threadIdx.x == 0) {
    tma::expect(&bars[S], (kT * kYStrip + (c > 0 ? kN * kP : 0)) * 2);
    for (int t = 0; t < kT; ++t) load128<kS>(sC + t * kYStrip, &a.mx, &bars[S], a.d + kN, r0 + t * kS, b);
    if (c > 0) {
      tma::load(sH, &a.mh16, &bars[S], 0, row16(a, b, c, h));
      tma::load(sH + kN * 64, &a.mh16, &bars[S], 64, row16(a, b, c, h));
    }
    for (int si = 0; si < kT && si < (c > 0 ? S - 1 : S); ++si) issue(si);
  }
  for (int i = threadIdx.x; i < a.Q; i += NT) {
    sS[i] = a.S[bh * a.L + r0 + i];
    sdt[i] = a.dt[bh * a.L + r0 + i];
  }
  __syncthreads();
  const bf16* sCw = sC + w * kYStrip;
  float y[64];
  zero(y);
  tma::wait(&bars[S], 0);
  if (c > 0) {  // e^S C bf16(h_in); h_in of the first chunk is 0
    keep(y);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wg::mma_ss<0, 1>(y, tma::kdesc(sCw, kS, kk, 0), tma::mndesc(sH, kN, kk), 1, Shape<128>{});
    wg::commit();
    wg::wait<0>();
    keep(y);
    const float e0 = expf(sS[t0 + wg::acc_row(0)]), e1 = expf(sS[t0 + wg::acc_row(2)]);
#pragma unroll
    for (int r = 0; r < 64; ++r) y[r] *= (r & 2) ? e1 : e0;
    __syncthreads();  // every warpgroup is past the product that read sH
    if (threadIdx.x == 0 && S - 1 < kT) issue(S - 1);
  }
  for (int si = 0; si < kT; ++si) {
    tma::wait(&bars[si % S], (si / S) & 1);
    bf16* st = ring + (si % S) * kYStage;
    const bool mine = si <= w;  // the strips from the tile's on take it
    float g[32];
    zero(g);
    if (mine) {
      keep(g);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wg::mma_ss<0, 0>(g, tma::kdesc(sCw, kS, kk, 0), tma::kdesc(st, kS, kk, 0), 1, Shape<64>{});
      wg::commit();
    }
    const float* dts = sdt + si * kS;  // bf16(x dt), while G's products run
    xform_rows<kS, 2, NT>(st + kS * kN, [=](int s, float v) { return v * dts[s]; });
    written();
    if (threadIdx.x == 0 && si >= 1 && si + S - 1 < kT) issue(si + S - 1);  // tile si - 1's stage
    if (mine) {
      wg::wait<0>();
      keep(g);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int t = t0 + wg::acc_row(r), s = si * kS + wg::acc_col(r);
        g[r] = s <= t ? g[r] * expf(sS[t] - sS[s]) : 0.f;
      }
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::frag_bf16(af[kk], g, kk);
      keep(af);
      keep(y);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_rs<1>(y, af[kk], tma::mndesc(st + kS * kN, kS, kk), 1, Shape<128>{});
      wg::commit();
      wg::wait<0>();
      keep(y);
      keep(af);
    }
  }
  const float skip = a.Dp[h];
  const long long row0 = b * static_cast<long long>(a.L) + r0 + t0;
#pragma unroll
  for (int r = 0; r < 64; r += 2) {
    const int t = wg::acc_row(r), p = h * kP + wg::acc_col(r);
    const uint32_t xw =
        *reinterpret_cast<const uint32_t*>(a.xbc + b * a.sb + (r0 + t0 + t) * a.sr + p);
    *reinterpret_cast<uint32_t*>(a.y + (row0 + t) * a.d + p) =
        wg::pack(y[r] + skip * lo16(xw), y[r + 1] + skip * hi16(xw));
  }
}

// ---------------------------------------------------------------------------
// backward (K9)

// The operands, outputs and scratch of one backward. Tensor maps: mx / mx32
// xbc in 64 x 64 / 64 x 32 boxes; mdy / mdy32 dy likewise; mdh the dh
// scratch (rows of p, fp32) in unswizzled 128 x 32 boxes; mdhs the same in
// swizzled boxes of 32 columns and NB rows, mh16 hin16 in boxes of 64
// columns and NB rows (bwd_dbc's part of n). xbc and dy (bf16) with their
// strides; dt, S (b, h, L), Dp (h), hin (b, nc, h, n, p) fp32; dhfin (b, h,
// n, p) fp32 the seed of the carry, or null. Outputs: dxbc (b, L, d + 2n)
// bf16 contiguous; ddt, dS (b, h, L); dD_part (b, h, nc, q / 64). Scratch,
// fp32: dG (b, nc, q, q) the head sum of bf16(dG) over the lower tile pairs;
// dh (b, nd, h, n, p): the cotangent of the state leaving chunk c in slot c
// (nd = nc - 1, or nc when seeded); hin16 (b, nc - 1, h, n, p) bf16: h_in of
// chunks 1 .. nc - 1 rounded; rs, cs (b, h, nc, tile pairs, 64) the row and
// column sums of dlogM; dT (b, h, L); dE (2, b, h, L), its sums over the two
// halves of n; hsum (b, h, nc, 2) the halves' sums of dh (.) h_in.
struct Bwd {
  CUtensorMap mx, mx32, mdy, mdy32, mdh, mdhs, mh16;
  const bf16* xbc;
  long long sb, sr;
  const bf16* dy;
  long long dsb, dsr;
  const float* dt;
  const float* S;
  const float* Dp;
  const float* hin;
  const float* dhfin;
  bf16* dxbc;
  float* ddt;
  float* dS;
  float* dD_part;
  float *dG, *dh, *rs, *cs, *dT, *dE, *hsum;
  bf16* hin16;
  int B, L, H, Q, d;
  int nd;  // the chunks with a dh: nc - 1, or nc when seeded
};

// the state-sized slot of (b, chunk c, h) in dh (c < nd), and in hin; the
// row (of p) where it starts in dh and in hin16 (c >= 1)
__device__ __forceinline__ long long dh_at(const Bwd& a, int b, int c, int h) {
  return ((static_cast<long long>(b) * a.nd + c) * a.H + h) * (kN * kP);
}
__device__ __forceinline__ long long hin_at(const Bwd& a, int b, int c, int h) {
  return ((static_cast<long long>(b) * (a.L / a.Q) + c) * a.H + h) * (kN * kP);
}
__device__ __forceinline__ int dh_row(const Bwd& a, int b, int c, int h) {
  return ((b * a.nd + c) * a.H + h) * kN;
}
__device__ __forceinline__ int h16_row(const Bwd& a, int b, int c, int h) {
  return ((b * (a.L / a.Q - 1) + c - 1) * a.H + h) * kN;
}

// Per (b, h), one warpgroup a 64-row half of n: the dh carry, from the last
// chunk down, dh_out[c - 1] = e^{S_end[c]} dh_out[c] + (C_c E_c)^T dy_c
// (dh_out[nc - 1] = dh_fin, or 0), kept in the accumulator from chunk to
// chunk, 3xTF32 in 32-row slabs of the chunk: A = (C E)^T from registers (C
// E split as hi + lo), B = dy^T (exact in tf32; K-major, transposed in
// shared memory once for both halves), the lo term first; four stages. Each
// dh_out[c] is written with the half's sum of dh_out (.) h_in, and h_in[c]
// rounded to bf16 for dC.
constexpr int kCarryRows = 32;
constexpr int kCarryStages = 4;
constexpr int kCarryStage = kCarryRows * (kN + kP);  // bf16 elements: C's slab, dy's

__global__ void __launch_bounds__(2 * kThreads, 2) bwd_state(const __grid_constant__ Bwd a) {
  constexpr int NT = 2 * kThreads, S = kCarryStages, R = kCarryRows;
  __shared__ __align__(8) uint64_t full[S];
  __shared__ float sE[S][R];
  __shared__ float red[8];
  bf16* ring = reinterpret_cast<bf16*>(smem_base());
  float* sY = reinterpret_cast<float*>(ring + S * kCarryStage);  // dy^T, tf32
  const int half = threadIdx.x >> 7, h = blockIdx.x % a.H, b = blockIdx.x / a.H;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const int nc = a.L / a.Q, spc = a.Q / R, slabs = (nc - 1) * spc;
  const int tq = threadIdx.x & 3;
  const bool seeded = a.nd == nc;
  auto row_of = [&](int i) { return (nc - 1 - i / spc) * a.Q + i % spc * R; };
  auto issue = [&](int i) {  // chunk nc - 1 - i / spc, its slab i % spc: C and dy raw
    bf16* st = ring + (i % S) * kCarryStage;
    tma::expect(&full[i % S], kCarryStage * 2);
    load128<R>(st, &a.mx32, &full[i % S], a.d + kN, row_of(i), b);
    load128<R>(st + R * kN, &a.mdy32, &full[i % S], h * kP, row_of(i), b);
  };
  auto energies = [&](int i) {
    if (threadIdx.x < R) sE[i % S][threadIdx.x] = expf(a.S[bh * a.L + row_of(i) + threadIdx.x]);
  };
  float acc[64];
  // acc holds dh_out[cc]: write it, the half's sum of it with h_in[cc], and
  // h_in[cc] in bf16 (cc >= 1; with no seed, at cc = nc - 2 h_in[nc - 1] too)
  auto emit = [&](int cc) {
    const long long mine = half * 64 * kP;
    float* dst = a.dh + dh_at(a, b, cc, h) + mine;
    const float* hc = a.hin + hin_at(a, b, cc, h) + mine;
    bf16* h16 = a.hin16 + static_cast<long long>(h16_row(a, b, cc, h)) * kP + mine;
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < 64; r += 2) {
      const int e = wg::acc_row(r) * kP + wg::acc_col(r);
      *reinterpret_cast<float2*>(dst + e) = make_float2(acc[r], acc[r + 1]);
      const float2 hv = *reinterpret_cast<const float2*>(hc + e);
      part += acc[r] * hv.x;
      part += acc[r + 1] * hv.y;
      if (cc >= 1) *reinterpret_cast<uint32_t*>(h16 + e) = wg::pack(hv.x, hv.y);
      if (!seeded && cc == nc - 2) {
        const float2 hn = *reinterpret_cast<const float2*>(a.hin + hin_at(a, b, nc - 1, h) + mine + e);
        *reinterpret_cast<uint32_t*>(a.hin16 + static_cast<long long>(h16_row(a, b, nc - 1, h)) * kP +
                                     mine + e) = wg::pack(hn.x, hn.y);
      }
    }
    const float total = wg_sum(part, red);
    if ((threadIdx.x & 127) == 0) a.hsum[(bh * nc + cc) * 2 + half] = total;
  };
  init_bars(full, S);
  for (int i = 0; i < S && i < slabs; ++i) {
    if (threadIdx.x == 0) issue(i);
    energies(i);
  }
  zero(acc);
  if (seeded) {
    const float* src = a.dhfin + bh * (kN * kP) + half * 64 * kP;
#pragma unroll
    for (int r = 0; r < 64; r += 2) {
      const float2 v = *reinterpret_cast<const float2*>(src + wg::acc_row(r) * kP + wg::acc_col(r));
      acc[r] = v.x;
      acc[r + 1] = v.y;
    }
  }
  __syncthreads();
  // step -1 (seeded only) writes dh_out[nc - 1] = dh_fin; step i >= 0 takes
  // slab i, and the last slab of chunk c writes dh_out[c - 1]
  for (int i = seeded ? -1 : 0; i < slabs; ++i) {
    const int c = nc - 1 - i / spc, j = i % spc;
    if (i >= 0) {
      if (i > 0) {  // every warpgroup's products of slab i - 1 are done: sY and its stage are free
        __syncthreads();
        if (i + S - 1 < slabs) {
          if (threadIdx.x == 0) issue(i + S - 1);
          energies(i + S - 1);
        }
      }
      tma::wait(&full[i % S], (i / S) & 1);
      if (j == 0) {  // acc holds dh_out[c]: decay it across chunk c
        const float decay = expf(a.S[bh * a.L + static_cast<long long>(c + 1) * a.Q - 1]);
#pragma unroll
        for (int r = 0; r < 64; ++r) acc[r] *= decay;
      }
      const bf16* st = ring + (i % S) * kCarryStage;
      to_tf32_t<R, kP, NT>(sY, st + R * kN);
      written();
      const float* es = sE[i % S];
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = half * 64 + wg::frag_row(e & 1), s = kk * 8 + tq + 4 * (e >> 1);
          wg::split_tf32(f(st[tma::at16(s, n, R)]) * es[s], ah[kk][e], al[kk][e]);
        }
      keep(acc);
      keep(ah);
      keep(al);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = wg::desc(sY, kP, kk, 0);
        wg::mma_tf32(acc, al[kk], db, 1, Shape<128>{});
        wg::mma_tf32(acc, ah[kk], db, 1, Shape<128>{});
      }
      wg::commit();
      wg::wait<0>();
      keep(acc);
      keep(ah);
      keep(al);
    }
    if (i < 0 || (j == spc - 1 && c >= 1)) emit(i < 0 ? nc - 1 : c - 1);
  }
}

// Per (b, chunk, head), one warpgroup a 64-row strip s of the chunk (kT of
// them): dxdt = (B_s dh_out) T_end + the sum over the t tiles from the strip
// on of bf16(GM)^T dy, then dx = dxdt dt + D dy, ddt = rowsum(dxdt (.) x),
// dT = rowsum((B dh) (.) x dt) and the strip's dD partial. B dh: 3xTF32 (A =
// B_s from registers, exact in tf32; B = dh^T split as hi + lo, transposed in
// shared memory from dh's raw rows, in four 32-wide slabs of n, the lo term
// first), where the chunk has a dh. G^T = B_s C_t^T of each tile pair on the
// tensor cores, masked and decayed in registers and fed as the register A of
// the product with dy_t (MN-major). The warpgroups share dh's slabs and each
// t tile of C and dy. Shared memory: B's strips (K-major), a ring of
// y_stages {C's t tile (K-major), dy's (MN-major)}, which first holds dh's
// raw slabs (all but the last stage) and their hi and lo tiles (the last).
constexpr int kDxStage = kS * kN + kS * kP;  // bf16 elements: C's t tile, dy's
constexpr int kDhSlab = 32 * kP;             // floats: 32 rows of dh, raw

template <int kT>
__global__ void __launch_bounds__(kT * kThreads, min_blocks(kT)) bwd_dx(const __grid_constant__ Bwd a) {
  constexpr int NT = kT * kThreads, S = y_stages(kT), RW = 2 * (S - 1);  // RW: raw dh slabs held
  __shared__ __align__(8) uint64_t bars[S + 1 + RW];  // the stages', B's strips', dh's slabs'
  __shared__ float red[kT * 4];
  __shared__ float sS[kMaxChunk], sdt[kMaxChunk], sTe[kMaxChunk];
  bf16* sB = reinterpret_cast<bf16*>(smem_base());
  unsigned char* ring = reinterpret_cast<unsigned char*>(sB + kT * kYStrip);
  float* raw = reinterpret_cast<float*>(ring);
  float* hi = reinterpret_cast<float*>(ring + (S - 1) * kDxStage * 2);
  float* lo = hi + kDhSlab;
  const int nc = a.L / a.Q, w = threadIdx.x >> 7, tq = threadIdx.x & 3;
  const int h = blockIdx.x % a.H, c = blockIdx.x / a.H % nc, b = blockIdx.x / a.H / nc;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const int r0 = c * a.Q, s0 = w * kS;
  const bool has_dh = c < a.nd;
  auto issue = [&](int ti) {  // C's and dy's t tile
    bf16* st = reinterpret_cast<bf16*>(ring + (ti % S) * kDxStage * 2);
    tma::expect(&bars[ti % S], kDxStage * 2);
    load128<kS>(st, &a.mx, &bars[ti % S], a.d + kN, r0 + ti * kS, b);
    load128<kS>(st + kS * kN, &a.mdy, &bars[ti % S], h * kP, r0 + ti * kS, b);
  };
  auto issue_dh = [&](int j) {  // dh's rows 32 j .. 32 j + 31
    uint64_t* bar = &bars[S + 1 + j % RW];
    tma::expect(bar, kDhSlab * 4);
    tma::load(raw + (j % RW) * kDhSlab, &a.mdh, bar, 0, dh_row(a, b, c, h) + j * 32);
  };
  init_bars(bars, S + 1 + RW);
  if (threadIdx.x == 0) {
    tma::expect(&bars[S], kT * kYStrip * 2);
    for (int t = 0; t < kT; ++t) load128<kS>(sB + t * kYStrip, &a.mx, &bars[S], a.d, r0 + t * kS, b);
    if (has_dh)
      for (int j = 0; j < RW && j < kN / 32; ++j) issue_dh(j);
    else
      for (int ti = 0; ti < S && ti < kT; ++ti) issue(ti);
  }
  const float send = a.S[bh * a.L + r0 + a.Q - 1];
  for (int i = threadIdx.x; i < a.Q; i += NT) {
    const float s = a.S[bh * a.L + r0 + i];
    sS[i] = s;
    sdt[i] = a.dt[bh * a.L + r0 + i];
    sTe[i] = expf(send - s);
  }
  __syncthreads();
  const bf16* sBw = sB + w * kYStrip;
  float acc[64];
  zero(acc);
  float dT[2] = {0.f, 0.f};
  const int row0 = wg::acc_row(0), row1 = wg::acc_row(2);
  const bf16* xs = a.xbc + b * a.sb + static_cast<long long>(r0 + s0) * a.sr + h * kP;
  tma::wait(&bars[S], 0);
  if (has_dh) {
    for (int j = 0; j < kN / 32; ++j) {
      if (j > 0) __syncthreads();  // the products of slab j - 1 are done: hi and lo are free
      tma::wait(&bars[S + 1 + j % RW], (j / RW) & 1);
      const float* rj = raw + (j % RW) * kDhSlab;
      for (int i = threadIdx.x; i < kP * 8; i += NT) {  // dh^T's (p, 4 n) rows, split
        const int p = i % kP, n = i / kP * 4;
        uint32_t hv[4], lv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) wg::split_tf32(rj[(n + e) * kP + p], hv[e], lv[e]);
        *reinterpret_cast<uint4*>(hi + wg::tf32_at(p, n, kP)) = uint4{hv[0], hv[1], hv[2], hv[3]};
        *reinterpret_cast<uint4*>(lo + wg::tf32_at(p, n, kP)) = uint4{lv[0], lv[1], lv[2], lv[3]};
      }
      written();
      if (threadIdx.x == 0) {
        if (j + RW < kN / 32) issue_dh(j + RW);  // into the slab it just left
        if (j == kN / 32 - 1)  // every raw slab is consumed
          for (int ti = 0; ti < S - 1 && ti < kT; ++ti) issue(ti);
      }
      uint32_t av[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = wg::frag_row(e & 1), n = j * 32 + kk * 8 + tq + 4 * (e >> 1);
          av[kk][e] = __float_as_uint(f(sBw[tma::at16(s, n, kS)]));
        }
      keep(acc);
      keep(av);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::mma_tf32(acc, av[kk], wg::desc(lo, kP, kk, 0), 1, Shape<128>{});
        wg::mma_tf32(acc, av[kk], wg::desc(hi, kP, kk, 0), 1, Shape<128>{});
      }
      wg::commit();
      wg::wait<0>();
      keep(acc);
      keep(av);
    }
    row_sums(acc, [&](int r, float v) {
      const int s = wg::acc_row(r), p = wg::acc_col(r);
      return v * f(xs[s * a.sr + p]) * sdt[s0 + s];
    }, dT);
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] *= sTe[s0 + wg::acc_row(r)];
    __syncthreads();  // hi and lo are consumed
    if (threadIdx.x == 0 && S - 1 < kT) issue(S - 1);
  }
  if (tq == 0) {
    a.dT[bh * a.L + r0 + s0 + row0] = dT[0];
    a.dT[bh * a.L + r0 + s0 + row1] = dT[1];
  }
  for (int ti = 0; ti < kT; ++ti) {
    if (ti > 0) {  // every warpgroup is past tile ti - 1: its stage takes tile ti + S - 1
      __syncthreads();
      if (threadIdx.x == 0 && ti + S - 1 < kT) issue(ti + S - 1);
    }
    tma::wait(&bars[ti % S], (ti / S) & 1);
    const bf16* st = reinterpret_cast<const bf16*>(ring + (ti % S) * kDxStage * 2);
    if (ti >= w) {  // the t tiles from the strip on
      float g[32];
      zero(g);
      keep(g);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wg::mma_ss<0, 0>(g, tma::kdesc(sBw, kS, kk, 0), tma::kdesc(st, kS, kk, 0), 1, Shape<64>{});
      wg::commit();
      wg::wait<0>();
      keep(g);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int s = s0 + wg::acc_row(r), t = ti * kS + wg::acc_col(r);
        g[r] = t >= s ? g[r] * expf(sS[t] - sS[s]) : 0.f;
      }
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg::frag_bf16(af[kk], g, kk);
      keep(af);
      keep(acc);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_rs<1>(acc, af[kk], tma::mndesc(st + kS * kN, kS, kk), 1, Shape<128>{});
      wg::commit();
      wg::wait<0>();
      keep(acc);
      keep(af);
    }
  }
  float ddt[2];
  row_sums(acc, [&](int r, float v) {
    return v * f(xs[wg::acc_row(r) * a.sr + wg::acc_col(r)]);
  }, ddt);
  if (tq == 0) {
    a.ddt[bh * a.L + r0 + s0 + row0] = ddt[0];
    a.ddt[bh * a.L + r0 + s0 + row1] = ddt[1];
  }
  const float skip = a.Dp[h];
  const long long total = a.d + 2 * kN;
  bf16* dxs = a.dxbc + (b * static_cast<long long>(a.L) + r0 + s0) * total + h * kP;
  const bf16* dys = a.dy + b * a.dsb + static_cast<long long>(r0 + s0) * a.dsr + h * kP;
  float part = 0.f;
#pragma unroll
  for (int r = 0; r < 64; r += 2) {
    const int s = wg::acc_row(r), p = wg::acc_col(r);
    const float dt_s = sdt[s0 + s];
    const uint32_t dyw = *reinterpret_cast<const uint32_t*>(dys + s * a.dsr + p);
    const uint32_t xw = *reinterpret_cast<const uint32_t*>(xs + s * a.sr + p);
    *reinterpret_cast<uint32_t*>(dxs + s * total + p) =
        wg::pack(acc[r] * dt_s + skip * lo16(dyw), acc[r + 1] * dt_s + skip * hi16(dyw));
    part += lo16(dyw) * lo16(xw);
    part += hi16(dyw) * hi16(xw);
  }
  const float t = wg_sum(part, red);
  if ((threadIdx.x & 127) == 0) a.dD_part[(bh * nc + c) * kT + w] = t;
}

// Tile pair index of (ti, si), si <= ti, over a chunk's lower triangle of
// 64 x 64 tiles, and back.
__host__ __device__ __forceinline__ int pair_index(int ti, int si) { return ti * (ti + 1) / 2 + si; }
__device__ __forceinline__ void pair_tiles(int pi, int& ti, int& si) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= pi) ++ti;
  si = pi - ti * (ti + 1) / 2;
}

// Per (b, chunk, lower tile pair (ti, si)): G = C_t B_s^T once on the tensor
// cores, then for each head in turn dGM = dy_t bf16(x_s dt_s)^T (both
// K-major), the head sum of bf16(dGM (.) M) in registers (written to dG at
// the end, exact 0 above the diagonal), and the row and column sums of
// dlogM = dGM (.) G (.) M into rs / cs. The heads' tiles land in halves of p
// (an atom of dy_t's and one of x_s's), four stages.
constexpr int kDgmStages = 4;
constexpr int kDgmStage = 2 * kS * 64;  // bf16 elements: 64 columns of dy_t, of x_s

__global__ void __launch_bounds__(kThreads, 3) bwd_dgm(const __grid_constant__ Bwd a) {
  constexpr int S = kDgmStages;
  __shared__ __align__(8) uint64_t bars[S + 1];  // the stages', then C's and B's tiles'
  __shared__ float sv[2][3 * kS];                // per head: S_t, S_s, dt_s
  __shared__ float red[4 * kS], sums[kS];
  bf16* sC = reinterpret_cast<bf16*>(smem_base());
  bf16* sB = sC + kS * kN;
  bf16* ring = sB + kS * kN;
  const int nc = a.L / a.Q, T = a.Q / kS, pairs = T * (T + 1) / 2, units = 2 * a.H;
  const int pi = blockIdx.x % pairs, c = blockIdx.x / pairs % nc, b = blockIdx.x / pairs / nc;
  int ti, si;
  pair_tiles(pi, ti, si);
  const int t0 = ti * kS, s0 = si * kS, r0 = c * a.Q;
  const long long Q = a.Q;
  auto issue = [&](int u) {  // head u / 2, columns 64 (u % 2) .. of its p
    bf16* st = ring + (u % S) * kDgmStage;
    const int col = (u >> 1) * kP + (u & 1) * 64;
    tma::expect(&bars[u % S], kDgmStage * 2);
    tma::load(st, &a.mdy, &bars[u % S], col, r0 + t0, b);
    tma::load(st + kS * 64, &a.mx, &bars[u % S], col, r0 + s0, b);
  };
  auto values = [&](int h) {
    const long long bh = static_cast<long long>(b) * a.H + h;
    if (threadIdx.x < kS) {
      sv[h & 1][threadIdx.x] = a.S[bh * a.L + r0 + t0 + threadIdx.x];
      sv[h & 1][kS + threadIdx.x] = a.S[bh * a.L + r0 + s0 + threadIdx.x];
      sv[h & 1][2 * kS + threadIdx.x] = a.dt[bh * a.L + r0 + s0 + threadIdx.x];
    }
  };
  init_bars(bars, S + 1);
  if (threadIdx.x == 0) {
    tma::expect(&bars[S], 2 * kS * kN * 2);
    load128<kS>(sC, &a.mx, &bars[S], a.d + kN, r0 + t0, b);
    load128<kS>(sB, &a.mx, &bars[S], a.d, r0 + s0, b);
    for (int u = 0; u < S && u < units; ++u) issue(u);
  }
  values(0);
  __syncthreads();
  float g[32], dgs[32], d[32];
  zero(g);
  zero(dgs);
  tma::wait(&bars[S], 0);
  keep(g);
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
    wg::mma_ss<0, 0>(g, tma::kdesc(sC, kS, kk, 0), tma::kdesc(sB, kS, kk, 0), 1, Shape<64>{});
  wg::commit();
  wg::wait<0>();
  keep(g);
  for (int u = 0; u < units; ++u) {
    const int h = u >> 1;
    tma::wait(&bars[u % S], (u / S) & 1);
    bf16* st = ring + (u % S) * kDgmStage;
    const float* v = sv[h & 1];
    xform_rows<kS, 1, kThreads>(st + kS * 64, [=](int s, float x) { return x * v[2 * kS + s]; });
    written();
    if (threadIdx.x == 0 && u >= 1 && u + S - 1 < units) issue(u + S - 1);  // u - 1's stage
    if ((u & 1) == 0) {
      if (h + 1 < a.H) values(h + 1);
      zero(d);
    }
    keep(d);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_ss<0, 0>(d, tma::kdesc(st, kS, kk, 0), tma::kdesc(st + kS * 64, kS, kk, 0), 1,
                       Shape<64>{});
    wg::commit();
    wg::wait<0>();
    keep(d);
    if ((u & 1) == 0) continue;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int t = wg::acc_row(r), s = wg::acc_col(r);
      float dl = 0.f;
      if (s0 + s <= t0 + t) {
        const float mm = expf(v[t] - v[kS + s]);
        dgs[r] += rbf(d[r] * mm);
        dl = d[r] * (g[r] * mm);
      }
      d[r] = dl;
    }
    const long long bh = static_cast<long long>(b) * a.H + h;
    const long long at = ((bh * nc + c) * pairs + pi) * kS;
    float rsum[2];
    row_sums(d, [](int, float x) { return x; }, rsum);
    if ((threadIdx.x & 3) == 0) {
      a.rs[at + wg::acc_row(0)] = rsum[0];
      a.rs[at + wg::acc_row(2)] = rsum[1];
    }
    col_sums64(d, red, sums);
    if (threadIdx.x < kS) a.cs[at + threadIdx.x] = sums[threadIdx.x];
  }
  float* dGt = a.dG + (static_cast<long long>(b) * nc + c) * Q * Q + t0 * Q + s0;
#pragma unroll
  for (int r = 0; r < 32; r += 2)
    *reinterpret_cast<float2*>(dGt + wg::acc_row(r) * Q + wg::acc_col(r)) =
        make_float2(dgs[r], dgs[r + 1]);
}

// Per (b, chunk, NB-wide part of n, group of kW strips) and one of dC (even
// blocks) or dB (odd), one warpgroup a 64-row strip:
//   dC = sum_h E (dy bf16(h_in)^T) (bf16 products: A = dy's strip from
//        registers, B = bf16(h_in)'s rows of the part, K-major; each head's
//        dE over each half of n on the way) + dG B (3xTF32: A = dG from
//        registers, split; B = B^T, K-major, transposed in shared memory);
//   dB = sum_h ((bf16(x dt) dh^T) T_end) (3xTF32: A = bf16(x dt) from
//        registers, exact; B = dh's rows of the part split in shared memory
//        as hi + lo, in 32-wide slabs of p) + dG^T C (3xTF32: A = dG^T from
//        registers, split; B = C^T);
// the heads in order, the per-head products skipped where h_in or dh is 0;
// the fp32 sums rounded to bf16 once. Every A operand comes straight from
// device memory into registers; the group's warpgroups share each head's
// h_in or dh tile and each B^T or C^T tile (a strip takes the s tiles up to
// its diagonal for dC, the t tiles from it for dB). NB (all 128 of n, or
// half) and kW (the strips a block) as dbc_shape picks them by the card's SM
// count. Shared memory: a ring of three stages of NB x 128 bf16 (bf16(h_in)'s
// part, or dh's slab as hi and lo); then four raw 64-row tiles of B or C in
// the first two stages and the tf32 B^T / C^T tile in the third.
template <int NB>
struct Dbc {
  static constexpr int kStages = 3;
  static constexpr int kStage = NB * kP * 2;  // bytes
  static constexpr int kRaw = kS * NB * 2;    // bytes: a raw tile of B or C
  static constexpr int kSmem = kStages * kStage + 1024;
  static_assert(4 * kRaw == 2 * kStage, "four raw tiles fill two stages");
};

// acc += A B over the 64 x 64 dG tile of rows m, columns k at dG (row pitch
// Q floats; with kTr the tile's rows are k and its columns m: A = dG^T) and
// a tf32 B tile of N extent NB over k = 64: 3xTF32, the lo term first (B is
// exact in tf32). A is read from device memory into registers.
template <bool kTr, int NB>
__device__ __forceinline__ void dg_product(float (&acc)[NB / 2], const float* dG, long long Q,
                                           const float* sBt) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += 4) {  // two halves of k: half the fragments live
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wg::frag_row(e & 1), k = (k0 + kk) * 8 + tq + 4 * (e >> 1);
        wg::split_tf32(kTr ? dG[k * Q + m] : dG[m * Q + k], ah[kk][e], al[kk][e]);
      }
    keep(acc);
    keep(ah);
    keep(al);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = wg::desc(sBt, NB, k0 + kk, 0);
      wg::mma_tf32(acc, al[kk], db, 1, Shape<NB>{});
      wg::mma_tf32(acc, ah[kk], db, 1, Shape<NB>{});
    }
    wg::commit();
    wg::wait<0>();
    keep(acc);
    keep(ah);
    keep(al);
  }
}

template <int kW, int NB>
__global__ void __launch_bounds__(kW * kThreads, NB == 64 ? min_blocks(kW) : 1) bwd_dbc(const __grid_constant__ Bwd a) {
  constexpr int NT = kW * kThreads, kParts = kN / NB, R = NB / 2;
  using D = Dbc<NB>;
  constexpr int S = D::kStages;
  __shared__ __align__(8) uint64_t bars[S + 4];  // the stages', the raw tiles'
  __shared__ float sF[2][kMaxChunk];  // per head: E (dC), or dt (dB), of the chunk's rows
  __shared__ float sT[2][kMaxChunk];  // per head: T_end (dB)
  unsigned char* ring = smem_base();
  const int nc = a.L / a.Q, T = a.Q / kS, groups = T / kW;
  const int w = threadIdx.x >> 7, tq = threadIdx.x & 3;
  const int is_db = blockIdx.x & 1, nh = (blockIdx.x >> 1) % kParts, rest = (blockIdx.x >> 1) / kParts;
  const int sg = rest % groups, c = rest / groups % nc, b = rest / groups / nc;
  const int strip = sg * kW + w, n0 = nh * NB;
  const long long Q = a.Q, r0 = static_cast<long long>(c) * a.Q;
  const int r = strip * kS;  // the strip's first row: t0 (dC), s0 (dB)
  const int f0 = wg::frag_row(0), f1 = wg::frag_row(1);
  const float* dGc = a.dG + (static_cast<long long>(b) * nc + c) * Q * Q;
  const long long total = a.d + 2 * kN, BHL = static_cast<long long>(a.B) * a.H * a.L;
  init_bars(bars, S + 4);
  float acc[R];
  zero(acc);
  if (!is_db && c > 0) {  // the heads' E (dy bf16(h_in)^T); h_in of the first chunk is 0
    auto issue = [&](int h) {
      bf16* st = reinterpret_cast<bf16*>(ring + (h % S) * D::kStage);
      tma::expect(&bars[h % S], D::kStage);
      tma::load(st, &a.mh16, &bars[h % S], 0, h16_row(a, b, c, h) + n0);
      tma::load(st + NB * 64, &a.mh16, &bars[h % S], 64, h16_row(a, b, c, h) + n0);
    };
    auto energies = [&](int h) {
      const long long bh = static_cast<long long>(b) * a.H + h;
      for (int i = threadIdx.x; i < a.Q; i += NT) sF[h & 1][i] = expf(a.S[bh * a.L + r0 + i]);
    };
    if (threadIdx.x == 0)
      for (int h = 0; h < S && h < a.H; ++h) issue(h);
    energies(0);
    const bf16* Ct = a.xbc + b * a.sb + (r0 + r) * a.sr + a.d + kN + n0;
    for (int h = 0; h < a.H; ++h) {
      __syncthreads();  // every warpgroup is past head h - 1; sF[h & 1] is written
      if (h > 0 && threadIdx.x == 0 && h + S - 1 < a.H) issue(h + S - 1);
      if (h + 1 < a.H) energies(h + 1);
      const long long bh = static_cast<long long>(b) * a.H + h;
      const bf16* dyt = a.dy + b * a.dsb + (r0 + r) * a.dsr + h * kP;
      uint32_t av[8][4];  // dy's strip, the register A
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          av[kk][e] = *reinterpret_cast<const uint32_t*>(
              dyt + ((e & 1) ? f1 : f0) * a.dsr + kk * 16 + 2 * tq + 8 * (e >> 1));
      tma::wait(&bars[h % S], (h / S) & 1);
      const bf16* sH = reinterpret_cast<const bf16*>(ring + (h % S) * D::kStage);
      float yh[R];
      zero(yh);
      keep(yh);
      keep(av);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk)
        wg::mma_rs<0>(yh, av[kk], tma::kdesc(sH, NB, kk, 0), 1, Shape<NB>{});
      wg::commit();
      wg::wait<0>();
      keep(yh);
      keep(av);
#pragma unroll
      for (int q = 0; q < NB / 64; ++q) {  // dE over each half of n, its columns 32 q ..
        float dE[2];
        row_sums(yh, [&](int e, float v) {
          return v * f(Ct[wg::acc_row(e) * a.sr + wg::acc_col(e)]);
        }, dE, 32 * q, 32 * q + 32);
        float* dEq = a.dE + (nh + q) * BHL + bh * a.L + r0 + r;
        if (tq == 0) {
          dEq[wg::acc_row(0)] = dE[0];
          dEq[wg::acc_row(2)] = dE[1];
        }
      }
      const float e0 = sF[h & 1][r + wg::acc_row(0)], e1 = sF[h & 1][r + wg::acc_row(2)];
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] += ((e & 2) ? e1 : e0) * yh[e];
    }
  } else if (!is_db) {
    for (int h = 0; h < a.H; ++h)
      for (int q = 0; q < NB / 64; ++q)
        if ((threadIdx.x & 127) < kS)
          a.dE[(nh + q) * BHL + (static_cast<long long>(b) * a.H + h) * a.L + r0 + r +
               (threadIdx.x & 127)] = 0.f;
  }
  if (is_db && c < a.nd) {  // the heads' (bf16(x dt) dh^T) T_end; a chunk with no dh skips
    auto issue = [&](int i) {  // head i / 4, p slab i % 4
      tma::expect(&bars[i % S], NB * 32 * 4);
      tma::load(ring + (i % S) * D::kStage, &a.mdhs, &bars[i % S], i % (kP / 32) * 32,
                dh_row(a, b, c, i / (kP / 32)) + n0);
    };
    auto values = [&](int h) {
      const long long bh = static_cast<long long>(b) * a.H + h;
      const float* Sc = a.S + bh * a.L + r0;
      for (int t = threadIdx.x; t < a.Q; t += NT) {
        sF[h & 1][t] = a.dt[bh * a.L + r0 + t];
        sT[h & 1][t] = expf(Sc[a.Q - 1] - Sc[t]);
      }
    };
    const int steps = a.H * (kP / 32);
    if (threadIdx.x == 0)
      for (int i = 0; i < S && i < steps; ++i) issue(i);
    values(0);
    __syncthreads();
    float xh[R];
    for (int i = 0; i < steps; ++i) {
      const int h = i / (kP / 32), j = i % (kP / 32);
      const bf16* xs = a.xbc + b * a.sb + (r0 + r) * a.sr + h * kP + j * 32;
      bf16 xv[4][4];  // x's strip, this slab's columns, for the register A
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xv[kk][e] = xs[((e & 1) ? f1 : f0) * a.sr + kk * 8 + tq + 4 * (e >> 1)];
      tma::wait(&bars[i % S], (i / S) & 1);
      float* hi = reinterpret_cast<float*>(ring + (i % S) * D::kStage);
      split_tile<NB, 32, NT>(hi, hi + NB * 32);  // dh's slab as tf32 hi + lo
      written();
      if (threadIdx.x == 0 && i >= 1 && i + S - 1 < steps) issue(i + S - 1);  // i - 1's stage
      if (j == 0 && h + 1 < a.H) values(h + 1);
      if (j == 0) zero(xh);
      uint32_t av[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          av[kk][e] = __float_as_uint(rbf(f(xv[kk][e]) * sF[h & 1][r + ((e & 1) ? f1 : f0)]));
      keep(xh);
      keep(av);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg::mma_tf32(xh, av[kk], tma::kdesc(hi + NB * 32, NB, kk, 0), 1, Shape<NB>{});
        wg::mma_tf32(xh, av[kk], tma::kdesc(hi, NB, kk, 0), 1, Shape<NB>{});
      }
      wg::commit();
      wg::wait<0>();
      keep(xh);
      keep(av);
      if (j == kP / 32 - 1) {
        const float e0 = sT[h & 1][r + wg::acc_row(0)], e1 = sT[h & 1][r + wg::acc_row(2)];
#pragma unroll
        for (int e = 0; e < R; ++e) acc[e] += ((e & 2) ? e1 : e0) * xh[e];
      }
    }
  }
  // dC += dG B over the s tiles up to the strip; dB += dG^T C over the t
  // tiles from it; B^T or C^T of each tile built once a block
  __syncthreads();  // the heads' stages are consumed
  const int k0 = is_db ? sg * kW : 0, k1 = is_db ? T : sg * kW + kW;
  float* sBt = reinterpret_cast<float*>(ring + 2 * D::kStage);
  auto raw = [&](int k) { return reinterpret_cast<bf16*>(ring + (k - k0) % 4 * D::kRaw); };
  auto issue_raw = [&](int k) {
    uint64_t* bar = &bars[S + (k - k0) % 4];
    tma::expect(bar, D::kRaw);
    for (int q = 0; q < NB / 64; ++q)
      tma::load(raw(k) + q * kS * 64, &a.mx, bar, a.d + (is_db ? kN : 0) + n0 + q * 64,
                static_cast<int>(r0) + k * kS, b);
  };
  if (threadIdx.x == 0)
    for (int k = k0; k < k1 && k < k0 + 4; ++k) issue_raw(k);
  for (int k = k0; k < k1; ++k) {
    if (k > k0) __syncthreads();  // the products of tile k - 1 are done: sBt is free
    tma::wait(&bars[S + (k - k0) % 4], ((k - k0) / 4) & 1);
    to_tf32_t<kS, NB, NT>(sBt, raw(k));
    written();
    if (threadIdx.x == 0 && k + 4 < k1) issue_raw(k + 4);
    if (is_db ? k >= strip : k <= strip) {
      if (is_db)
        dg_product<true, NB>(acc, dGc + k * kS * Q + r, Q, sBt);
      else
        dg_product<false, NB>(acc, dGc + r * Q + k * kS, Q, sBt);
    }
  }
  bf16* out = a.dxbc + (b * static_cast<long long>(a.L) + r0 + r) * total + a.d +
              (is_db ? 0 : kN) + n0;
#pragma unroll
  for (int e = 0; e < R; e += 2)
    *reinterpret_cast<uint32_t*>(out + wg::acc_row(e) * total + wg::acc_col(e)) =
        wg::pack(acc[e], acc[e + 1]);
}

// One (b, h, chunk) a block, a thread a row: dS = rowsum(dlogM) + dE E
// - dT T_end - colsum(dlogM), and at the chunk's last row dSend = sum(dT
// T_end) + e^{S_end} sum(dh (.) h_in), every sum in a fixed order.
__global__ void __launch_bounds__(kThreads) bwd_ds(const __grid_constant__ Bwd a) {
  __shared__ float red[4];
  const int nc = a.L / a.Q, T = a.Q / kS, pairs = T * (T + 1) / 2;
  const int c = blockIdx.x % nc;
  const long long bh = blockIdx.x / nc, r0 = static_cast<long long>(c) * a.Q;
  const long long at = bh * a.L + r0, base = (bh * nc + c) * pairs;
  const float send = a.S[at + a.Q - 1];
  float dtte = 0.f;
  for (int i = threadIdx.x; i < a.Q; i += kThreads) {
    float rowsum = 0.f, colsum = 0.f;
    const int tile = i / kS, row = i % kS;
    for (int si = 0; si <= tile; ++si) rowsum += a.rs[(base + pair_index(tile, si)) * kS + row];
    for (int ti = tile; ti < T; ++ti) colsum += a.cs[(base + pair_index(ti, tile)) * kS + row];
    const float s = a.S[at + i];
    const float dt_te = a.dT[at + i] * expf(send - s);
    dtte += dt_te;
    const float dE = a.dE[at + i] + a.dE[static_cast<long long>(a.B) * a.H * a.L + at + i];
    a.dS[at + i] = rowsum + dE * expf(s) - dt_te - colsum;
  }
  const float total = wg_sum(dtte, red);  // one warpgroup: the block's sum
  const float hs = c < a.nd ? a.hsum[(bh * nc + c) * 2] + a.hsum[(bh * nc + c) * 2 + 1] : 0.f;
  // the last row is its thread's last: nothing reads it in between
  if (threadIdx.x == (a.Q - 1) % kThreads) a.dS[at + a.Q - 1] += total + expf(send) * hs;
}

// ---------------------------------------------------------------------------
// launches

template <class K>
cudaError_t allow(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// dynamic shared memory of each kernel, bytes (1024 for the alignment)
constexpr int kStateSmem = kStateStages * kStateStage * 2 + 1024;
constexpr int y_smem(int kT) { return (kT * kYStrip + y_stages(kT) * kYStage) * 2 + 1024; }
constexpr int kCarrySmem = kCarryStages * kCarryStage * 2 + kP * kCarryRows * 4 + 1024;
constexpr int dx_smem(int kT) { return (kT * kYStrip + y_stages(kT) * kDxStage) * 2 + 1024; }
constexpr int kDgmSmem = (2 * kS * kN + kDgmStages * kDgmStage) * 2 + 1024;

bool geometry_ok(int L, int H, int d_inner, int N, int P, int Q) {
  return N == kN && P == kP && Q % kS == 0 && Q >= kS && Q <= kMaxChunk && L > 0 && L % Q == 0 &&
         H > 0 && d_inner == H * kP;
}

// the rows of a bf16 (b, L, cols) tensor at p, its batch and row strides in
// elements, as a map with 64-column boxes of `rows` rows, swizzled
bool map_rows(CUtensorMap* m, const void* p, int cols, int L, int B, long long sb, long long sr,
              int rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(L),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(sr) * 2, static_cast<uint64_t>(sb) * 2};
  const uint32_t box[3] = {64, static_cast<uint32_t>(rows), 1};
  return sr > 0 && sb > 0 && tma::encode(m, true, 3, p, dims, strides, box, true);
}

// states (slots of n rows of p) at p, `rows` rows in all, as a map with boxes
// of box_cols x box_rows, bf16 or fp32, swizzled or not
bool map_states(CUtensorMap* m, const void* p, bool bf16_, long long rows, int box_cols,
                int box_rows, bool swizzle) {
  const uint64_t dims[2] = {kP, static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(kP) * (bf16_ ? 2 : 4)};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols), static_cast<uint32_t>(box_rows)};
  return tma::encode(m, bf16_, 2, p, dims, strides, box, swizzle);
}

// fwd_y with kT strips a block
template <int kT>
cudaError_t launch_y(const Fwd& a, cudaStream_t s) {
  const int smem = y_smem(kT);
  cudaError_t err = allow(fwd_y<kT>, smem);
  if (err != cudaSuccess) return err;
  fwd_y<kT><<<a.B * (a.L / a.Q) * a.H, kT * kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool kStates, bool kFin>
cudaError_t launch_state(const Fwd& a, cudaStream_t s) {
  cudaError_t err = allow(fwd_state<kStates, kFin>, kStateSmem);
  if (err != cudaSuccess) return err;
  fwd_state<kStates, kFin><<<a.B * a.H, 2 * kThreads, kStateSmem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_fwd(const Fwd& a, bool states, bool fin, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (states || fin || a.L / a.Q > 1) {
    if (states)
      err = fin ? launch_state<true, true>(a, s) : launch_state<true, false>(a, s);
    else
      err = fin ? launch_state<false, true>(a, s) : launch_state<false, false>(a, s);
    if (err != cudaSuccess) return err;
  }
  switch (a.Q / kS) {
    case 1: return launch_y<1>(a, s);
    case 2: return launch_y<2>(a, s);
    case 3: return launch_y<3>(a, s);
    default: return launch_y<4>(a, s);
  }
}

long long bwd_scratch(int B, int L, int H, int Q, int seeded) {
  const long long nc = L / Q, T = Q / kS, pairs = T * (T + 1) / 2;
  const long long state = static_cast<long long>(H) * kN * kP;
  return B * nc * Q * Q + B * (nc - 1 + seeded) * state + B * (nc - 1) * state / 2 +
         2 * B * H * nc * pairs * kS + 3LL * B * H * L + 2 * B * H * nc;
}

// bwd_dx with kT strips a block
template <int kT>
cudaError_t launch_dx(const Bwd& a, cudaStream_t s) {
  const int smem = dx_smem(kT);
  cudaError_t err = allow(bwd_dx<kT>, smem);
  if (err != cudaSuccess) return err;
  bwd_dx<kT><<<a.B * (a.L / a.Q) * a.H, kT * kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// bwd_dbc with kW strips and NB columns of n a block (its own maps of the
// part's rows of hin16 and dh)
template <int kW, int NB>
cudaError_t launch_dbc(Bwd a, cudaStream_t s) {
  const int nc = a.L / a.Q;
  if (nc > 1 && !map_states(&a.mh16, a.hin16, true, static_cast<long long>(a.B) * (nc - 1) * a.H * kN,
                            64, NB, true))
    return cudaErrorInvalidValue;
  if (a.nd > 0 && !map_states(&a.mdhs, a.dh, false, static_cast<long long>(a.B) * a.nd * a.H * kN,
                              32, NB, true))
    return cudaErrorInvalidValue;
  cudaError_t err = allow(bwd_dbc<kW, NB>, Dbc<NB>::kSmem);
  if (err != cudaSuccess) return err;
  const int blocks = a.B * nc * 2 * (kN / NB) * (a.Q / kS / kW);
  bwd_dbc<kW, NB><<<blocks, kW * kThreads, Dbc<NB>::kSmem, s>>>(a);
  return cudaGetLastError();
}

// bwd_dbc's blocks: all of n and two strips a block where the chunk has an
// even number of strips and that still gives the card's SMs four blocks
// each; else all of n and one strip if that does; else half of n and one
// strip. (More warpgroups a block at all of n would spill their registers.)
// dE comes as the sums over the halves of n at every shape.
cudaError_t launch_dbc(const Bwd& a, cudaStream_t s) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int T = a.Q / kS, blocks = a.B * (a.L / a.Q) * 2 * T;  // one strip a block, all of n
  if (T % 2 == 0 && blocks / 2 >= 4 * sms) return launch_dbc<2, 128>(a, s);
  if (blocks >= 4 * sms) return launch_dbc<1, 128>(a, s);
  return launch_dbc<1, 64>(a, s);
}

cudaError_t launch_bwd(Bwd a, float* scratch, cudaStream_t s) {
  const int nc = a.L / a.Q, T = a.Q / kS, pairs = T * (T + 1) / 2;
  const long long state = static_cast<long long>(a.H) * kN * kP;
  a.dG = scratch;
  a.dh = a.dG + static_cast<long long>(a.B) * nc * a.Q * a.Q;
  a.hin16 = reinterpret_cast<bf16*>(a.dh + a.B * a.nd * state);
  a.rs = a.dh + a.B * a.nd * state + a.B * (nc - 1) * state / 2;
  a.cs = a.rs + static_cast<long long>(a.B) * a.H * nc * pairs * kS;
  a.dT = a.cs + static_cast<long long>(a.B) * a.H * nc * pairs * kS;
  a.dE = a.dT + static_cast<long long>(a.B) * a.H * a.L;
  a.hsum = a.dE + 2LL * a.B * a.H * a.L;
  if (a.nd > 0 &&
      !map_states(&a.mdh, a.dh, false, static_cast<long long>(a.B) * a.nd * a.H * kN, kP, 32, false))
    return cudaErrorInvalidValue;
  cudaError_t err = allow(bwd_state, kCarrySmem);
  if (err == cudaSuccess) err = allow(bwd_dgm, kDgmSmem);
  if (err != cudaSuccess) return err;
  if (a.nd > 0) {
    bwd_state<<<a.B * a.H, 2 * kThreads, kCarrySmem, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  bwd_dgm<<<a.B * nc * pairs, kThreads, kDgmSmem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  switch (T) {
    case 1: err = launch_dx<1>(a, s); break;
    case 2: err = launch_dx<2>(a, s); break;
    case 3: err = launch_dx<3>(a, s); break;
    default: err = launch_dx<4>(a, s);
  }
  if (err != cudaSuccess) return err;
  if ((err = launch_dbc(a, s)) != cudaSuccess) return err;
  bwd_ds<<<a.B * a.H * nc, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// bf16 K8 (lean, or with states; with h_fin where hfin is not null): xbc
// (B, L, d_inner + 2N) bf16 with strides (x_sb, x_sr, 1), its start and
// strides 16-byte aligned; dt, S (B, H, L / Q, Q) fp32 contiguous; Dp (H,);
// y (B, L, d_inner) bf16 contiguous; hin 16-byte aligned, hin_n floats: h_in
// (B, L / Q, H, N, P) when states is 1, else a scratch (B, L / Q - 1, H, N,
// P) for the states entering chunks 1 .. L / Q - 1; hfin (B, H, N, P) fp32
// or null; hin16 a bf16 scratch of hin16_n = B (L / Q - 1) H N P elements,
// 16-byte aligned.
// Returns a cudaError_t code: cudaErrorInvalidValue for a geometry this body
// does not serve (N, P other than 128, Q not a multiple of 64 from 64 to 256,
// L not a multiple of Q, d_inner other than H * P), xbc not 16-byte aligned,
// or hin of another size.
int ssd_sm90_fwd(const void* xbc, const void* dt, const void* S, const void* Dp, void* y,
                 void* hin, long long hin_n, int states, void* hfin, void* hin16,
                 long long hin16_n, int B, int L, int H, int d_inner, int N, int P, int Q,
                 long long x_sb, long long x_sr, void* stream) {
  if (!geometry_ok(L, H, d_inner, N, P, Q) || !aligned16(hin) || !aligned16(hin16) ||
      hin16_n != static_cast<long long>(B) * (L / Q - 1) * H * kN * kP)
    return cudaErrorInvalidValue;
  Fwd a{};
  a.xbc = static_cast<const bf16*>(xbc);
  a.sb = x_sb;
  a.sr = x_sr;
  a.dt = static_cast<const float*>(dt);
  a.S = static_cast<const float*>(S);
  a.Dp = static_cast<const float*>(Dp);
  a.y = static_cast<bf16*>(y);
  a.hin = static_cast<float*>(hin);
  a.hin16 = static_cast<bf16*>(hin16);
  a.hfin = static_cast<float*>(hfin);
  a.B = B;
  a.L = L;
  a.H = H;
  a.Q = Q;
  a.d = d_inner;
  a.slot0 = states ? 0 : 1;
  if (hin_n != static_cast<long long>(B) * (L / Q - a.slot0) * H * kN * kP)
    return cudaErrorInvalidValue;
  if (!map_rows(&a.mx, xbc, d_inner + 2 * kN, L, B, x_sb, x_sr, kS) ||
      (L / Q > 1 && !map_states(&a.mh16, hin16, true, hin16_n / kP, 64, kN, true)))
    return cudaErrorInvalidValue;
  return launch_fwd(a, states != 0, hfin != nullptr, static_cast<cudaStream_t>(stream));
}

// The floats of ssd_sm90_bwd's scratch, seeded (1) or not (0).
long long ssd_sm90_bwd_scratch_floats(int B, int L, int H, int Q, int seeded) {
  return bwd_scratch(B, L, H, Q, seeded);
}

// bf16 K9: xbc as ssd_sm90_fwd's; dt, S, Dp likewise; h_in (B, L / Q, H, N, P)
// fp32 contiguous, 16-byte aligned; dy (B, L, d_inner) bf16 with strides
// (dy_sb, dy_sr, 1), its start and strides 16-byte aligned; dh_fin (B, H, N,
// P) fp32 contiguous, the seed of the carry, or null. Outputs, contiguous:
// dxbc (B, L, d_inner + 2N) bf16; ddt, dS (B, H, L / Q, Q); dD_part
// (B, H, L / Q, Q / 64), dD_n floats. scratch: scratch_n floats, 16-byte
// aligned (ssd_sm90_bwd_scratch_floats). Returns a cudaError_t code, as
// ssd_sm90_fwd (also for a dD_part or scratch of another size).
int ssd_sm90_bwd(const void* xbc, const void* dt, const void* S, const void* Dp, const void* h_in,
                 const void* dy, const void* dh_fin, void* dxbc, void* ddt, void* dS,
                 void* dD_part, long long dD_n, void* scratch, long long scratch_n, int B, int L,
                 int H, int d_inner, int N, int P, int Q, long long x_sb, long long x_sr,
                 long long dy_sb, long long dy_sr, void* stream) {
  const int seeded = dh_fin != nullptr;
  if (!geometry_ok(L, H, d_inner, N, P, Q) || !aligned16(h_in) || !aligned16(scratch) ||
      (seeded && !aligned16(dh_fin)))
    return cudaErrorInvalidValue;
  if (dD_n != static_cast<long long>(B) * H * (L / Q) * (Q / kS) ||
      scratch_n != bwd_scratch(B, L, H, Q, seeded))
    return cudaErrorInvalidValue;
  Bwd a{};
  a.xbc = static_cast<const bf16*>(xbc);
  a.sb = x_sb;
  a.sr = x_sr;
  a.dy = static_cast<const bf16*>(dy);
  a.dsb = dy_sb;
  a.dsr = dy_sr;
  a.dt = static_cast<const float*>(dt);
  a.S = static_cast<const float*>(S);
  a.Dp = static_cast<const float*>(Dp);
  a.hin = static_cast<const float*>(h_in);
  a.dhfin = static_cast<const float*>(dh_fin);
  a.dxbc = static_cast<bf16*>(dxbc);
  a.ddt = static_cast<float*>(ddt);
  a.dS = static_cast<float*>(dS);
  a.dD_part = static_cast<float*>(dD_part);
  a.B = B;
  a.L = L;
  a.H = H;
  a.Q = Q;
  a.d = d_inner;
  a.nd = L / Q - 1 + seeded;
  if (!map_rows(&a.mx, xbc, d_inner + 2 * kN, L, B, x_sb, x_sr, kS) ||
      !map_rows(&a.mx32, xbc, d_inner + 2 * kN, L, B, x_sb, x_sr, kCarryRows) ||
      !map_rows(&a.mdy, dy, d_inner, L, B, dy_sb, dy_sr, kS) ||
      !map_rows(&a.mdy32, dy, d_inner, L, B, dy_sb, dy_sr, kCarryRows))
    return cudaErrorInvalidValue;
  return launch_bwd(a, static_cast<float*>(scratch), static_cast<cudaStream_t>(stream));
}

const char* ssd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

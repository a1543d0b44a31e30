// Chunked SSD backward, fp32 or bf16: K9, the backward of the boundary-fused
// K8, and K7, the backward of the split K6, one body serving both. For the forward of
// csrc/ssd_xbc_fwd.cu and the output gradient dy (b, l, d), per batch row b
// and head h, with GM = (C B^T) (.) M, M[t,s] = e^{S[t]-S[s]} (s <= t),
// E = e^S, T_end = e^{S_end - S} and dh the cotangent of the state leaving
// the chunk:
//
//   dxdt  = GM^T dy + (B dh) T_end,          dx = dxdt dt [+ D dy]
//   dGM   = dy (dt x)^T,  dG = dGM (.) M,    dlogM = dGM (.) GM
//   dC    = dG B + (dy h_in^T) E             (summed over heads)
//   dB    = dG^T C + (dt x T_end) dh^T       (summed over heads)
//   dS    = rowsum(dlogM) + dE E - dT T_end - colsum(dlogM) + [t = end] dSend
//           dE = rowsum(dy (.) C h_in), dT = rowsum((B dh) (.) dt x),
//           dSend = sum(dT T_end) + e^{S_end} sum(dh (.) h_in)
//   ddt   = rowsum(dxdt (.) x),  [dD = sum(dy (.) x)]
//   dh   <- e^{S_end} dh + (C E)^T dy        (the carry to the chunk before)
//
// K9 (`ssd_xbc_bwd`) replaces the TPU kernel `_make_bwd_kernel_xbc`
// (si_mamba_tpu/ops/pallas/ssd_kernel.py:623) behind `_bwd_call_xbc`
// (`pallas_call` at :698), with the per-head maths of `_bwd_head` (:241): x,
// B and C are the column groups of xbc, and dx, dB, dC the column groups of
// dxbc, with the D terms (kD). The dh of the last chunk is 0, or, for
// `ssd_xbc_bwd_seeded` (behind `_bwd_call_xbc(dh_fin=...)`, :678, the
// backward of `ssd_chunked_pallas_xbc(return_carry=True)`), the cotangent of
// h_fin (kSeed, as K7's seeded variant).
//
// K7 (`ssd_split_bwd`) replaces `_make_bwd_kernel` (ssd_kernel.py:216) behind
// `_bwd_call` (`pallas_call` at :388): x, B, C and dy arrive as separate
// operands with their own strides, as the tensor- and sequence-parallel
// mixers make them, dB and dC go to the two halves of one (b, l, 2n) buffer,
// and there are no D terms. Two variants: the dh carry from 0, or seeded
// with the cotangent of h_fin (kSeed, the sequence-parallel carry: the last
// chunk's dh terms and its dS_end term e^{S_end} sum(dh (.) h_in) are then
// not 0).
//
// Bound on the H100 at b=32, l=512, q=256, n=p=128: the function needs, per
// batch row, nc (3 q(q+1) n + 2h q(q+1) p) for the lower triangles of G,
// GM^T dy, dy (dt x)^T and of dG B, dG^T C taken once on dG summed over the
// heads, and (nc - 1) h 8qnp for dy h_in^T, the dh carry, B dh and
// (dt x T_end) dh^T (each is 0 or unread in the first or the last chunk; the
// seed adds the last chunk's h 4qnp). K9 (h=6): 14.5 GFLOP against about
// 211 MB moved (xbc, dy, h_in in; dxbc, dS, ddt out; 63 us at 3.35 TB/s); at
// the fp32 rate (67 TFLOP/s) 0.217 ms; as 3xTF32 on the tensor cores, three
// products for each against 495 TFLOP/s dense TF32, 0.088 ms. K7 at the
// tensor-parallel shard (h=3): 8.1 GFLOP against 122 MB, 0.049 ms as 3xTF32
// (0.120 ms at the fp32 rate).
//
// What held the earlier design back (grid (h, b), chunks walked in reverse in one
// block, 41.1 GFLOP executed on CUDA cores for K9), and what this one does
// about it:
//  1. Too few blocks (192 at B=32 for K9, 96 for K7 at the tensor-parallel
//     shard, one an SM for 228 KB). The forward saved h_in, so only dh
//     carries across chunks, and every (b, h, chunk) is independent once it
//     is known. Six launches: `bwd_prep` computes G of every lower 64 x 64
//     tile pair of every (b, chunk) into a (b, nc, q, q) scratch and every
//     chunk's local carry term (C E)^T dy into the dh scratch
//     (b, nc, h, n, p); `bwd_carry` walks the chunks in reverse in one
//     launch, dh_out[c] = e^{S_end[c+1]} dh_out[c+1] + (C E)^T dy[c+1]
//     (dh_out[nc-1] = dh_fin with kSeed), elementwise, with each chunk's
//     sum(dh (.) h_in) as fixed-order partials; `bwd_dgm` takes, per lower
//     tile pair and every head in turn, dGM, the head sum of dG (into a
//     (b, nc, q, q) scratch) and the row and column sums of dlogM; `bwd_dx`,
//     per (b, chunk, 64-row strip, head), dxdt = [B | GM^T] [dh ; dy] (B dh
//     first, for dT), dx, ddt and dD; `bwd_dbc`, per (b, chunk, 64-row strip)
//     and dB or dC, the head sums dC = dG B + sum_h E (dy h_in^T) (with each
//     head's dE) and dB = dG^T C + sum_h (dt x T_end) dh^T; `bwd_ds` finishes
//     dS. At B=32 and 6 heads: 1024, 3072 (16 a (b, h)), 640, 1536, 512 and
//     384 blocks.
//  2. 2.8x the products: G and dGM are computed once per tile (not twice), dB
//     and dC once on the head sum of dG (no per-head partials, no torch.sum
//     over them), no product whose operand is 0 or whose result is unread in
//     the first or last chunk, and a warp skips a k-tile whose masked rows are
//     all 0.
//  3. fp32 FFMA: every product is 3xTF32 mma.sync (csrc/ssd_tc.cuh) behind a
//     three-stage cp.async ring.
// Every sum across heads, tiles or blocks runs in a fixed order, without
// atomics, so two runs are bitwise equal. dD stays a per-(b, h, chunk,
// strip) partial that the wrapper's torch.sum finishes. h_in is the
// forward's: its first chunk's state is 0, and the products that would read
// it are skipped. Rows that are not 16-byte aligned land by 4-byte cp.async
// copies, chosen per operand.
//
// bf16 (the `_bf16` entry points), following `_bwd_head` (ssd_kernel.py:241)
// at bf16 activations: x, B, C and dy arrive and dx, dB and dC leave in bf16.
// The products whose operands `_bwd_head` rounds to bf16 are bf16 tensor-core
// products: G = C B^T, bf16(GM)^T dy, dy bf16(x dt)^T and dy bf16(h_in)^T. The
// products with the fp32 dh stay 3xTF32 (B dh, bf16(x dt) dh^T, then scaled by
// T_end, and the carry (C E)^T dy, whose tile of C is widened to fp32 for the
// factor E), as does dG B and dG^T C on the head sum of bf16(dG): the TPU
// kernel takes per head bf16(dG) B, whose sum over the heads is this product
// on the sum, which is not a bf16 value (B and C are exact in TF32). dB and dC
// are summed over the heads in fp32 and rounded once; ddt, dS and dD stay
// fp32. The fp32 body's products and launches are unchanged: each element
// type is its own instantiation.
//
// Wide states (the kWide instantiation): d_state n and head_dim p any
// multiples of 128, as `ssd_fused_supported` (ssd_kernel.py:70) compiles the
// TPU kernels. Tiles and shared memory stay as they are: bwd_prep's carry
// terms are (n / 64) x (p / 128) tiles, one block each; bwd_dgm's products over
// p run p / 32 k-tiles; bwd_dx and bwd_dbc walk their p / 128 (dx) or n / 128
// (dB, dC) column tiles in order inside the block, because dT, ddt, dD and dE
// sum across them (each row by the thread that writes it, so the backward stays
// bitwise repeatable); the contractions over n (G, B dh) run n / 32 k-tiles;
// bwd_carry stays elementwise, n p / 1024 blocks a (b, h), and so many partials
// of sum(dh (.) h_in) a (b, h, chunk). n = p = 128 is its own instantiation
// (kWide false), with n and p compile-time constants, as it was built before.
// At B=32, L=512, q=256, n = p = 256 and 3 heads K9 needs 22.6 GFLOP (0.137 ms
// as 3xTF32), K8 10.8 (0.065 ms) against 134 MB (0.040 ms).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "ssd_tc.cuh"

namespace {

using ssd_tc::Acc;
using ssd_tc::AllActive;
using ssd_tc::block_sum;
using ssd_tc::col_sums;
using ssd_tc::for_each;
using ssd_tc::frag_pos;
using ssd_tc::g_tile;
using ssd_tc::gemm;
using ssd_tc::is_bf16;
using ssd_tc::kBK;
using ssd_tc::kBM;
using ssd_tc::kRingFloats;
using ssd_tc::kThreads;
using ssd_tc::NoXform;
using ssd_tc::pair_index;
using ssd_tc::pair_tiles;
using ssd_tc::row_sums;
using ssd_tc::Src;
using ssd_tc::zero;

constexpr int kN = 128;         // d_state of the tuned instantiation
constexpr int kP = 128;         // head_dim of the tuned instantiation
constexpr int kTile = 128;      // d_state and head_dim are multiples of this
constexpr int kArrayFloor = 256;  // the per-chunk shared arrays' least length
constexpr int kMaxChunk = 8192;   // the longest chunk the dynamic shared memory holds
constexpr int kRed = 4 * kBM;     // row_sums' and col_sums' scratch

// The blocks a (b, h) of bwd_carry, and its partials of sum(dh (.) h_in) a
// (b, h, chunk): 4 state elements a thread (16 at n = p = 128).
__host__ __device__ inline int carry_parts(int N, int P) {
  return static_cast<int>(static_cast<long long>(N) * P / (kThreads * 4));
}
constexpr int kCarryParts = kN * kP / (kThreads * 4);  // carry_parts at n = p = 128

// The per-chunk shared arrays' length for chunk Q (up to 256 the length they
// always had, so the shared memory of those chunks is unchanged), and the
// dynamic shared memory of bwd_prep, bwd_dgm, bwd_dx and bwd_dbc.
int array_len(int Q) { return Q > kArrayFloor ? Q : kArrayFloor; }
int smem_bytes(int QS) {
  return static_cast<int>(sizeof(float)) * (kRingFloats + 3 * QS + kRed + kBM);
}

// One strided operand of element type T: base pointer (at its first column)
// and the batch and row strides in elements.
template <class T>
struct Operand {
  const T* p;
  long long sb, sr;
};

bool geometry_ok(int L, int N, int P, int Q) {
  return N > 0 && P > 0 && N % kTile == 0 && P % kTile == 0 && Q % kBM == 0 && Q > 0 && Q <= kMaxChunk && L % Q == 0;
}

// An output with its batch and row strides (unit stride along channels).
template <class T>
struct Out {
  T* p;
  long long sb, sr;
};

// The operands, outputs and scratch of one backward. x, B, C and dy (T) with
// their strides (x and dy at head 0's first column), al_* when their rows are
// 16-byte aligned; dt, S (b, h, L); Dp (h); hin (b, nc, h, n, p); dh_fin
// (b, h, n, p) for kSeed, all fp32. Outputs dx, dB, dC (T); ddt, dS (b, h, L);
// dD_part (b, h, nc, q / 64). Scratch, fp32: G and dG (b, nc, q, q); dh
// (b, nc, h, n, p); rs, cs (b, h, nc, tile pairs, 64); dT, dE (b, h, L); hsum
// (b, h, nc, carry_parts(n, p)).
template <class T>
struct Args {
  Operand<T> x, Bm, Cm, dy;
  const float* dt;
  const float* S;
  const float* Dp;
  const float* hin;
  const float* dh_fin;
  Out<T> dx, dB, dC;
  float* ddt;
  float* dS;
  float* dD_part;
  float *G, *dG, *dh, *rs, *cs, *dT, *dE, *hsum;
  int B, L, H, Q;
  int N, P;  // d_state and head_dim, read by the wide instantiation only
  int QS;    // the per-chunk shared arrays' length, array_len(Q)
  bool al_x, al_b, al_c, al_dy, al_hin;
};

// d_state, head_dim and carry_parts in a kernel: n = p = 128, fixed at
// compile time, in the tuned instantiation (kWide false); the launch's
// multiples of 128 in the wide one.
template <bool kWide, class A>
__device__ __forceinline__ int n_of(const A& a) {
  return kWide ? a.N : kN;
}
template <bool kWide, class A>
__device__ __forceinline__ int p_of(const A& a) {
  return kWide ? a.P : kP;
}
template <bool kWide, class A>
__device__ __forceinline__ long long np_of(const A& a) {
  return static_cast<long long>(n_of<kWide>(a)) * p_of<kWide>(a);
}
template <bool kWide, class A>
__device__ __forceinline__ int parts_of(const A& a) {
  return kWide ? carry_parts(a.N, a.P) : kCarryParts;
}

template <bool kWide, class T>
__device__ __forceinline__ long long state_at(const Args<T>& a, int b, int c, int h) {
  return ((static_cast<long long>(b) * (a.L / a.Q) + c) * a.H + h) * np_of<kWide>(a);
}

// Blocks [0, B nc pairs): one G tile pair each. The rest: one (b, h, chunk
// c >= 1, 64 x 128 tile of the (n, p) state: a 64-row half of n at n = 128)
// each, the chunk's carry term (C E)^T dy into dh's slot c - 1 (bwd_carry
// adds the decayed carry from the chunks after it), 3xTF32 at either element
// type (a bf16 C lands widened to fp32 for the factor E).
template <class T, bool kWide>
__global__ void __launch_bounds__(kThreads, 2) bwd_prep(Args<T> a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sF = smem + kRingFloats;
  const int nc = a.L / a.Q, T_ = a.Q / kBM, pairs = T_ * (T_ + 1) / 2;
  int bid = blockIdx.x;
  if (bid < a.B * nc * pairs) {
    const int pi = bid % pairs, c = bid / pairs % nc, b = bid / pairs / nc;
    int ti, si;
    pair_tiles(pi, ti, si);
    const long long r0 = static_cast<long long>(c) * a.Q;
    g_tile<T>(ring, Src<T>{a.Cm.p + b * a.Cm.sb + r0 * a.Cm.sr, a.Cm.sr, a.al_c},
              Src<T>{a.Bm.p + b * a.Bm.sb + r0 * a.Bm.sr, a.Bm.sr, a.al_b}, ti, si,
              a.G + (static_cast<long long>(b) * nc + c) * a.Q * a.Q, a.Q, n_of<kWide>(a));
    return;
  }
  bid -= a.B * nc * pairs;
  const int P = p_of<kWide>(a), halves = n_of<kWide>(a) / kBM, tiles = halves * (P / kTile);
  const int tile = bid % tiles, half = tile % halves, pt = tile / halves;
  bid /= tiles;
  const int h = bid % a.H, c = 1 + bid / a.H % (nc - 1), b = bid / a.H / (nc - 1);
  const long long bh = static_cast<long long>(b) * a.H + h, r0 = static_cast<long long>(c) * a.Q;
  for (int i = threadIdx.x; i < a.Q; i += kThreads) sF[i] = expf(a.S[bh * a.L + r0 + i]);
  Acc<128> acc;
  zero<128>(acc);
  const T* Cc = a.Cm.p + b * a.Cm.sb + r0 * a.Cm.sr + half * kBM;
  const T* dyc = a.dy.p + b * a.dy.sb + r0 * a.dy.sr + h * P + pt * kTile;
  const long long csr = a.Cm.sr, dysr = a.dy.sr;
  const bool alc = a.al_c, aldy = a.al_dy;
  gemm<128, true, false, false, float, T>(
      acc, ring, a.Q / kBK, [=](int kt) { return Src<T>{Cc + kt * kBK * csr, csr, alc}; },
      [=](int kt) { return Src<T>{dyc + kt * kBK * dysr, dysr, aldy}; },
      [=](int kt, int, int k, float v) { return v * sF[kt * kBK + k]; }, NoXform{}, AllActive{});
  float* dst = a.dh + state_at<kWide>(a, b, c - 1, h) + half * kBM * P + pt * kTile;
  for_each<128>(acc, [=](int m, int n, float v) { dst[m * P + n] = v; });
}

// dh_out[c] = e^{S_end[c+1]} dh_out[c+1] + (the carry term in slot c), from
// the last chunk whose dh is read (nc - 2, or nc - 1 = dh_fin with kSeed) down
// to 0, in place; each chunk's sum(dh_out (.) h_in) over this block's 1024
// elements goes to hsum. Grid (B h, carry_parts(n, p)), 4 elements a thread.
template <class T, bool kSeed, bool kWide>
__global__ void __launch_bounds__(kThreads) bwd_carry(Args<T> a) {
  __shared__ float red[kThreads / 32];
  const int nc = a.L / a.Q, top = kSeed ? nc - 1 : nc - 2;
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / a.H), h = static_cast<int>(bh % a.H);
  const float* Sb = a.S + bh * a.L;
  const int e0 = blockIdx.y * kThreads * 4 + threadIdx.x;
  float cur[4];
  for (int c = top; c >= 0; --c) {
    float* sc = a.dh + state_at<kWide>(a, b, c, h);
    const float* hc = a.hin + state_at<kWide>(a, b, c, h);
    const float decay = c == top ? 0.f : expf(Sb[static_cast<long long>(c + 2) * a.Q - 1]);
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * kThreads;
      float v;
      if (kSeed && c == nc - 1) {
        v = a.dh_fin[bh * np_of<kWide>(a) + e];
        sc[e] = v;
      } else if (c == top) {
        v = sc[e];
      } else {
        v = decay * cur[j] + sc[e];
        sc[e] = v;
      }
      cur[j] = v;
      part += v * hc[e];
    }
    const float total = block_sum(part, red);
    if (threadIdx.x == 0) a.hsum[(bh * nc + c) * parts_of<kWide>(a) + blockIdx.y] = total;
  }
}

// One lower tile pair (ti, si) of one (b, chunk) a block; for each head in
// turn dGM = dy (dt x)^T over the tile, dG = dGM (.) M summed over the heads
// in registers (written to the dG scratch at the end, exact 0 above the
// diagonal), and the row and column sums of dlogM = dGM (.) G (.) M into
// rs / cs. fp32: dy x^T as 3xTF32, then the factor dt; bf16: dy bf16(x dt)^T
// as bf16 products, each head's dG rounded to bf16 before the head sum; the
// products over the head's p columns in p / 32 k-tiles.
template <class T, bool kWide>
__global__ void __launch_bounds__(kThreads, 2) bwd_dgm(Args<T> a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sSt = smem + kRingFloats;  // S of the tile's t rows, its s rows, dt of its s rows
  float* sSs = sSt + kBM;
  float* sdts = sSs + kBM;
  float* red = sSt + 3 * a.QS;
  float* sums = red + kRed;
  const int nc = a.L / a.Q, T_ = a.Q / kBM, pairs = T_ * (T_ + 1) / 2;
  const int pi = blockIdx.x % pairs, c = blockIdx.x / pairs % nc, b = blockIdx.x / pairs / nc;
  int ti, si;
  pair_tiles(pi, ti, si);
  const int t0 = ti * kBM, s0 = si * kBM;
  const long long Q = a.Q, r0 = static_cast<long long>(c) * a.Q;
  const float* Gt = a.G + (static_cast<long long>(b) * nc + c) * Q * Q;
  Acc<64> gv, dgs;
  for_each<64>(gv, [=](int m, int n, float& v) { v = Gt[(t0 + m) * Q + s0 + n]; });
  zero<64>(dgs);
  const long long dysr = a.dy.sr, xsr = a.x.sr;
  const bool aldy = a.al_dy, alx = a.al_x;
  const int P = p_of<kWide>(a);
  for (int h = 0; h < a.H; ++h) {
    const long long bh = static_cast<long long>(b) * a.H + h;
    const float* Sc = a.S + bh * a.L + r0;
    if (threadIdx.x < kBM) {
      sSt[threadIdx.x] = Sc[t0 + threadIdx.x];
      sSs[threadIdx.x] = Sc[s0 + threadIdx.x];
      sdts[threadIdx.x] = a.dt[bh * a.L + r0 + s0 + threadIdx.x];
    }
    Acc<64> acc;
    zero<64>(acc);
    const T* dyt = a.dy.p + b * a.dy.sb + (r0 + t0) * dysr + h * P;
    const T* xs = a.x.p + b * a.x.sb + (r0 + s0) * xsr + h * P;
    auto src_dy = [=](int kt) { return Src<T>{dyt + kt * kBK, dysr, aldy}; };
    auto src_x = [=](int kt) { return Src<T>{xs + kt * kBK, xsr, alx}; };
    if constexpr (is_bf16<T>) {
      gemm<64, false, true, true, T, T>(
          acc, ring, P / kBK, src_dy, src_x, NoXform{},
          [=](int, int, int n, float v) { return v * sdts[n]; }, AllActive{});
    } else {
      gemm<64, false, true, false, T, T>(acc, ring, P / kBK, src_dy, src_x, NoXform{},
                                         NoXform{}, AllActive{});
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < ssd_tc::Cfg<64>::kNT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int m, n;
          frag_pos<64>(mi, ni, r, m, n);
          const float dgm = is_bf16<T> ? acc[mi][ni][r] : acc[mi][ni][r] * sdts[n];
          float dl = 0.f;
          if (s0 + n <= t0 + m) {
            const float mm = expf(sSt[m] - sSs[n]);
            dgs[mi][ni][r] += round_to<T>(dgm * mm);
            dl = dgm * (gv[mi][ni][r] * mm);
          }
          acc[mi][ni][r] = dl;
        }
    const long long at = ((bh * nc + c) * pairs + pi) * kBM;
    row_sums<64>(acc, [](int, int, float v) { return v; }, red, sums);
    if (threadIdx.x < kBM) a.rs[at + threadIdx.x] = sums[threadIdx.x];
    col_sums<64>(acc, [](int, int, float v) { return v; }, red, sums);
    if (threadIdx.x < kBM) a.cs[at + threadIdx.x] = sums[threadIdx.x];
  }
  float* dGt = a.dG + (static_cast<long long>(b) * nc + c) * Q * Q;
  for_each<64>(dgs, [=](int m, int n, float v) { dGt[(t0 + m) * Q + s0 + n] = v; });
}

// One (b, chunk, 64-row strip, head) a block: B dh (for dT, then scaled by
// T_end; not in a chunk whose dh is 0; 3xTF32) plus GM^T dy (bf16: bf16(GM)^T
// dy as bf16 products), then dx, ddt and dD, over the head's p / 128 column
// tiles in order (one at p = 128), dT's and ddt's row sums summed across
// them in that order.
template <class T, bool kD, bool kSeed, bool kWide>
__global__ void __launch_bounds__(kThreads, 2) bwd_dx(Args<T> a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sS = smem + kRingFloats;
  float* sdt = sS + a.QS;
  float* sTe = sdt + a.QS;
  float* red = sTe + a.QS;
  float* sums = red + kRed;
  const int nc = a.L / a.Q, T_ = a.Q / kBM;
  const int N = n_of<kWide>(a), P = p_of<kWide>(a);
  int bid = blockIdx.x;
  const int h = bid % a.H;
  bid /= a.H;
  const int ss = bid % T_;
  bid /= T_;
  const int c = bid % nc, b = bid / nc;
  const long long bh = static_cast<long long>(b) * a.H + h, r0 = static_cast<long long>(c) * a.Q;
  const long long Q = a.Q;
  const float send = a.S[bh * a.L + r0 + Q - 1];
  for (int i = threadIdx.x; i < a.Q; i += kThreads) {
    const float s = a.S[bh * a.L + r0 + i];
    sS[i] = s;
    sdt[i] = a.dt[bh * a.L + r0 + i];
    sTe[i] = expf(send - s);
  }
  const int s0 = ss * kBM;
  const long long xsr = a.x.sr, dysr = a.dy.sr, bsr = a.Bm.sr;
  const bool aldy = a.al_dy, alb = a.al_b;
  const bool has_dh = kSeed || c < nc - 1;
  float part = 0.f;
  for (int pt = 0; pt < P / kTile; ++pt) {
    const T* xs = a.x.p + b * a.x.sb + (r0 + s0) * xsr + h * P + pt * kTile;
    const T* dys = a.dy.p + b * a.dy.sb + (r0 + s0) * dysr + h * P + pt * kTile;
    Acc<128> acc;
    zero<128>(acc);
    if (has_dh) {
      const T* Bs = a.Bm.p + b * a.Bm.sb + (r0 + s0) * bsr;
      const float* dhc = a.dh + state_at<kWide>(a, b, c, h) + pt * kTile;
      gemm<128, false, false, false, T, float>(
          acc, ring, N / kBK, [=](int kt) { return Src<T>{Bs + kt * kBK, bsr, alb}; },
          [=](int kt) { return Src<float>{dhc + kt * kBK * P, P, true}; }, NoXform{}, NoXform{},
          AllActive{});
      row_sums<128>(
          acc, [=](int m, int n, float v) { return v * to_f(xs[m * xsr + n]) * sdt[s0 + m]; },
          red, sums);
      for_each<128>(acc, [=](int m, int, float& v) { v *= sTe[s0 + m]; });
    }
    // dT and ddt: the column tiles' row sums added in their order, each row
    // by the one thread that writes it
    float* dTr = a.dT + bh * a.L + r0 + s0 + threadIdx.x;
    if (threadIdx.x < kBM) {
      const float v = has_dh ? sums[threadIdx.x] : 0.f;
      *dTr = pt == 0 ? v : *dTr + v;
    }
    const float* Gs = a.G + (static_cast<long long>(b) * nc + c) * Q * Q + s0;
    gemm<128, true, false, is_bf16<T>, float, T>(
        acc, ring, (a.Q - s0) / kBK,
        [=](int kt) { return Src<float>{Gs + (s0 + kt * kBK) * Q, Q, true}; },
        [=](int kt) { return Src<T>{dys + kt * kBK * dysr, dysr, aldy}; },
        [=](int kt, int m, int k, float v) {
          const int t = s0 + kt * kBK + k, s = s0 + m;
          return t >= s ? v * expf(sS[t] - sS[s]) : 0.f;
        },
        NoXform{}, [=](int kt, int wm) { return kt * kBK + 31 >= wm * 32; });
    row_sums<128>(acc, [=](int m, int n, float v) { return v * to_f(xs[m * xsr + n]); }, red,
                  sums);
    float* ddtr = a.ddt + bh * a.L + r0 + s0 + threadIdx.x;
    if (threadIdx.x < kBM) *ddtr = pt == 0 ? sums[threadIdx.x] : *ddtr + sums[threadIdx.x];
    const float skip = kD ? a.Dp[h] : 0.f;
    T* dxs = a.dx.p + b * a.dx.sb + (r0 + s0) * a.dx.sr + h * P + pt * kTile;
    const long long dxsr = a.dx.sr;
    for_each<128>(acc, [&](int m, int n, float v) {
      if (kD) {
        const float dyv = to_f(dys[m * dysr + n]);
        dxs[m * dxsr + n] = from_f<T>(v * sdt[s0 + m] + skip * dyv);
        part += dyv * to_f(xs[m * xsr + n]);
      } else {
        dxs[m * dxsr + n] = from_f<T>(v * sdt[s0 + m]);
      }
    });
  }
  if (kD) {
    const float total = block_sum(part, red);
    if (threadIdx.x == 0) a.dD_part[(bh * nc + c) * T_ + ss] = total;
  }
}

// One (b, chunk, 64-row strip) and one of dC (even blocks) or dB (odd) a block,
// over the n / 128 column tiles of dC or dB in order (one at n = 128):
//   dC = dG B + sum_h E (dy h_in^T), writing each head's dE on the way (its
//        row sums over the column tiles summed in their order);
//   dB = dG^T C + sum_h (dt x T_end) dh^T;
// the heads in order, the per-head products skipped where h_in or dh is 0.
// bf16: dy bf16(h_in)^T as bf16 products; (bf16(x dt) dh^T) T_end with the
// factor T_end after the product (3xTF32); dG B and dG^T C 3xTF32 on the head
// sum of bf16(dG); the fp32 sums rounded to bf16 once.
template <class T, bool kSeed, bool kWide>
__global__ void __launch_bounds__(kThreads, 2) bwd_dbc(Args<T> a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sF = smem + kRingFloats;
  float* sTe = sF + kBM;
  float* red = sF + 3 * a.QS;
  float* sums = red + kRed;
  const int nc = a.L / a.Q, T_ = a.Q / kBM;
  const int N = n_of<kWide>(a), P = p_of<kWide>(a);
  const int is_db = blockIdx.x & 1, strip = (blockIdx.x >> 1) % T_,
            c = (blockIdx.x >> 1) / T_ % nc, b = (blockIdx.x >> 1) / T_ / nc;
  const long long Q = a.Q, r0 = static_cast<long long>(c) * a.Q;
  const int r = strip * kBM;  // the strip's first row: t0 for dC, s0 for dB
  const float* dGc = a.dG + (static_cast<long long>(b) * nc + c) * Q * Q;
  const long long xsr = a.x.sr, dysr = a.dy.sr, bsr = a.Bm.sr, csr = a.Cm.sr;
  const bool alx = a.al_x, aldy = a.al_dy, alb = a.al_b, alc = a.al_c, alhin = a.al_hin;
  if (!is_db) {
    for (int nt = 0; nt < N / kTile; ++nt) {
      Acc<128> acc;
      zero<128>(acc);
      const T* Ct = a.Cm.p + b * a.Cm.sb + (r0 + r) * csr + nt * kTile;
      for (int h = 0; h < a.H; ++h) {
        const long long bh = static_cast<long long>(b) * a.H + h;
        float* dEt = a.dE + bh * a.L + r0 + r;
        if (c == 0) {  // h_in of the first chunk is 0
          if (threadIdx.x < kBM) dEt[threadIdx.x] = 0.f;
          continue;
        }
        __syncthreads();  // the previous head is done with sF
        if (threadIdx.x < kBM) sF[threadIdx.x] = expf(a.S[bh * a.L + r0 + r + threadIdx.x]);
        Acc<128> yh;
        zero<128>(yh);
        const T* dyt = a.dy.p + b * a.dy.sb + (r0 + r) * dysr + h * P;
        const float* hc =
            a.hin + state_at<kWide>(a, b, c, h) + static_cast<long long>(nt) * kTile * P;
        gemm<128, false, true, is_bf16<T>, T, float>(
            yh, ring, P / kBK, [=](int kt) { return Src<T>{dyt + kt * kBK, dysr, aldy}; },
            [=](int kt) { return Src<float>{hc + kt * kBK, P, alhin}; }, NoXform{}, NoXform{},
            AllActive{});
        row_sums<128>(yh, [=](int m, int n, float v) { return v * to_f(Ct[m * csr + n]); }, red,
                      sums);
        if (threadIdx.x < kBM)
          dEt[threadIdx.x] = nt == 0 ? sums[threadIdx.x] : dEt[threadIdx.x] + sums[threadIdx.x];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < ssd_tc::Cfg<128>::kNT; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              int m, n;
              frag_pos<128>(mi, ni, e, m, n);
              acc[mi][ni][e] += sF[m] * yh[mi][ni][e];
            }
      }
      const T* Bc = a.Bm.p + b * a.Bm.sb + r0 * bsr + nt * kTile;
      const float* dGt = dGc + r * Q;
      gemm<128, false, false, false, float, T>(
          acc, ring, (r + kBM) / kBK, [=](int kt) { return Src<float>{dGt + kt * kBK, Q, true}; },
          [=](int kt) { return Src<T>{Bc + kt * kBK * bsr, bsr, alb}; }, NoXform{}, NoXform{},
          [=](int kt, int wm) { return kt * kBK <= r + wm * 32 + 31; });
      T* out = a.dC.p + b * a.dC.sb + (r0 + r) * a.dC.sr + nt * kTile;
      const long long osr = a.dC.sr;
      for_each<128>(acc, [=](int m, int n, float v) { out[m * osr + n] = from_f<T>(v); });
    }
    return;
  }
  for (int nt = 0; nt < N / kTile; ++nt) {
    Acc<128> acc;
    zero<128>(acc);
    if (kSeed || c < nc - 1) {  // the last chunk's dh is 0
      for (int h = 0; h < a.H; ++h) {
        const long long bh = static_cast<long long>(b) * a.H + h;
        __syncthreads();  // the previous head is done with sF
        if (threadIdx.x < kBM) {
          const float* Sc = a.S + bh * a.L + r0;
          const float dtv = a.dt[bh * a.L + r0 + r + threadIdx.x];
          const float te = expf(Sc[a.Q - 1] - Sc[r + threadIdx.x]);
          if (is_bf16<T>) {
            sF[threadIdx.x] = dtv;
            sTe[threadIdx.x] = te;
          } else {
            sF[threadIdx.x] = dtv * te;
          }
        }
        const T* xs = a.x.p + b * a.x.sb + (r0 + r) * xsr + h * P;
        const float* dhc =
            a.dh + state_at<kWide>(a, b, c, h) + static_cast<long long>(nt) * kTile * P;
        auto src_x = [=](int kt) { return Src<T>{xs + kt * kBK, xsr, alx}; };
        auto src_dh = [=](int kt) { return Src<float>{dhc + kt * kBK, P, true}; };
        if constexpr (is_bf16<T>) {
          Acc<128> xh;
          zero<128>(xh);
          gemm<128, false, true, false, T, float>(
              xh, ring, P / kBK, src_x, src_dh,
              [=](int, int m, int, float v) { return v * sF[m]; }, NoXform{}, AllActive{});
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < ssd_tc::Cfg<128>::kNT; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                int m, n;
                frag_pos<128>(mi, ni, e, m, n);
                acc[mi][ni][e] += sTe[m] * xh[mi][ni][e];
              }
        } else {
          gemm<128, false, true, false, T, float>(
              acc, ring, P / kBK, src_x, src_dh,
              [=](int, int m, int, float v) { return v * sF[m]; }, NoXform{}, AllActive{});
        }
      }
    }
    const T* Cc = a.Cm.p + b * a.Cm.sb + r0 * csr + nt * kTile;
    const float* dGs = dGc + r;
    gemm<128, true, false, false, float, T>(
        acc, ring, (a.Q - r) / kBK,
        [=](int kt) { return Src<float>{dGs + (r + kt * kBK) * Q, Q, true}; },
        [=](int kt) { return Src<T>{Cc + (r + kt * kBK) * csr, csr, alc}; }, NoXform{}, NoXform{},
        [=](int kt, int wm) { return kt * kBK + 31 >= wm * 32; });
    T* out = a.dB.p + b * a.dB.sb + (r0 + r) * a.dB.sr + nt * kTile;
    const long long osr = a.dB.sr;
    for_each<128>(acc, [=](int m, int n, float v) { out[m * osr + n] = from_f<T>(v); });
  }
}

// One (b, h, chunk) a block, a thread a row (rows i, i + 256, ... for a chunk
// longer than 256): dS = rowsum(dlogM) + dE E - dT T_end - colsum(dlogM),
// and at the chunk's last row dSend = sum(dT T_end) + e^{S_end} sum(dh (.)
// h_in), every sum in a fixed order.
template <class T, bool kSeed, bool kWide>
__global__ void __launch_bounds__(kThreads) bwd_ds(Args<T> a) {
  __shared__ float red[kThreads / 32];
  const int nc = a.L / a.Q, T_ = a.Q / kBM, pairs = T_ * (T_ + 1) / 2;
  const int c = blockIdx.x % nc;
  const long long bh = blockIdx.x / nc, r0 = static_cast<long long>(c) * a.Q;
  const long long at = bh * a.L + r0;
  const float send = a.S[at + a.Q - 1];
  float dtte = 0.f;  // this thread's rows' sum of dT T_end
  for (int i = threadIdx.x; i < a.Q; i += kThreads) {
    const long long base = (bh * nc + c) * pairs;
    float rowsum = 0.f, colsum = 0.f;
    const int tile = i / kBM, row = i % kBM;
    for (int si = 0; si <= tile; ++si) rowsum += a.rs[(base + pair_index(tile, si)) * kBM + row];
    for (int ti = tile; ti < T_; ++ti) colsum += a.cs[(base + pair_index(ti, tile)) * kBM + row];
    const float s = a.S[at + i];
    const float dt_te = a.dT[at + i] * expf(send - s);
    dtte += dt_te;
    a.dS[at + i] = rowsum + a.dE[at + i] * expf(s) - dt_te - colsum;
  }
  const float total = block_sum(dtte, red);
  float hs = 0.f;
  if (c <= (kSeed ? nc - 1 : nc - 2))
    for (int j = 0; j < parts_of<kWide>(a); ++j)
      hs += a.hsum[(bh * nc + c) * parts_of<kWide>(a) + j];
  // the last row is its thread's last: nothing reads it in between
  if (threadIdx.x == (a.Q - 1) % kThreads) a.dS[at + a.Q - 1] += total + expf(send) * hs;
}

template <class K>
cudaError_t allow_smem(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The floats of the scratch that one backward needs, in the order Args
// lists it.
long long scratch_floats(int B, int L, int H, int Q, int N, int P) {
  const long long nc = L / Q, T_ = Q / kBM, pairs = T_ * (T_ + 1) / 2;
  return 2 * B * nc * Q * Q + B * nc * H * static_cast<long long>(N) * P +
         2 * B * H * nc * pairs * kBM + 2 * static_cast<long long>(B) * H * L +
         B * H * nc * carry_parts(N, P);
}

template <class T, bool kD, bool kSeed, bool kWide>
cudaError_t launch(Args<T> a, float* scratch, cudaStream_t stream) {
  a.QS = array_len(a.Q);
  const int smem = smem_bytes(a.QS);
  const int nc = a.L / a.Q, T_ = a.Q / kBM, pairs = T_ * (T_ + 1) / 2;
  const long long qq = static_cast<long long>(a.B) * nc * a.Q * a.Q;
  const long long rows = static_cast<long long>(a.B) * a.H * a.L;
  const long long tiles = static_cast<long long>(a.B) * a.H * nc * pairs * kBM;
  a.G = scratch;
  a.dG = a.G + qq;
  a.dh = a.dG + qq;
  a.rs = a.dh + static_cast<long long>(a.B) * nc * a.H * a.N * a.P;
  a.cs = a.rs + tiles;
  a.dT = a.cs + tiles;
  a.dE = a.dT + rows;
  a.hsum = a.dE + rows;
  const int state_tiles = a.N / kBM * (a.P / kTile);
  cudaError_t err = allow_smem(bwd_prep<T, kWide>, smem);
  if (err == cudaSuccess) err = allow_smem(bwd_dgm<T, kWide>, smem);
  if (err == cudaSuccess) err = allow_smem(bwd_dx<T, kD, kSeed, kWide>, smem);
  if (err == cudaSuccess) err = allow_smem(bwd_dbc<T, kSeed, kWide>, smem);
  if (err != cudaSuccess) return err;
  bwd_prep<T, kWide>
      <<<a.B * nc * pairs + a.B * a.H * (nc - 1) * state_tiles, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (kSeed || nc > 1) {
    bwd_carry<T, kSeed, kWide>
        <<<dim3(a.B * a.H, carry_parts(a.N, a.P)), kThreads, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  bwd_dgm<T, kWide><<<a.B * nc * pairs, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dx<T, kD, kSeed, kWide><<<a.B * nc * T_ * a.H, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dbc<T, kSeed, kWide><<<a.B * nc * T_ * 2, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_ds<T, kSeed, kWide><<<a.B * a.H * nc, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The tuned instantiation at n = p = 128, the wide one at any other
// multiples of 128; the carry from 0 or seeded.
template <class T, bool kD>
cudaError_t launch_variant(const Args<T>& a, float* scratch, bool seeded, cudaStream_t s) {
  if (a.N == kN && a.P == kP)
    return seeded ? launch<T, kD, true, false>(a, scratch, s)
                  : launch<T, kD, false, false>(a, scratch, s);
  return seeded ? launch<T, kD, true, true>(a, scratch, s)
                : launch<T, kD, false, true>(a, scratch, s);
}

// Whether the scratch is the geometry's size and 16-byte aligned.
template <class T>
bool scratch_ok(const Args<T>& a, const void* scratch, long long scratch_n) {
  return scratch_n == scratch_floats(a.B, a.L, a.H, a.Q, a.N, a.P) &&
         ssd_tc::aligned16(scratch, 0, 0);
}

template <class T>
int xbc_bwd(const void* xbc, const void* dt, const void* S, const void* Dp, const void* h_in,
            const void* dy, const void* dh_fin, void* dxbc, void* ddt, void* dS, void* dD_part,
            long long dD_n, void* scratch, long long scratch_n, int B, int L, int H,
            int d_inner, int N, int P, int Q, long long x_sb, long long x_sr, long long dy_sb,
            long long dy_sr, void* stream) {
  if (!geometry_ok(L, N, P, Q) || d_inner != H * P || !ssd_tc::aligned4<T>(xbc, x_sb, x_sr) ||
      !ssd_tc::aligned4<T>(dy, dy_sb, dy_sr))
    return cudaErrorInvalidValue;
  if (dD_n != static_cast<long long>(B) * H * (L / Q) * (Q / kBM)) return cudaErrorInvalidValue;
  const auto* xf = static_cast<const T*>(xbc);
  auto* dxf = static_cast<T*>(dxbc);
  const long long total = d_inner + 2 * N;
  const bool al = ssd_tc::aligned16<T>(xf, x_sb, x_sr);
  Args<T> a{};
  a.x = Operand<T>{xf, x_sb, x_sr};
  a.Bm = Operand<T>{xf + d_inner, x_sb, x_sr};
  a.Cm = Operand<T>{xf + d_inner + N, x_sb, x_sr};
  a.dy = Operand<T>{static_cast<const T*>(dy), dy_sb, dy_sr};
  a.dt = static_cast<const float*>(dt);
  a.S = static_cast<const float*>(S);
  a.Dp = static_cast<const float*>(Dp);
  a.hin = static_cast<const float*>(h_in);
  a.dh_fin = static_cast<const float*>(dh_fin);
  a.dx = Out<T>{dxf, L * total, total};
  a.dB = Out<T>{dxf + d_inner, L * total, total};
  a.dC = Out<T>{dxf + d_inner + N, L * total, total};
  a.ddt = static_cast<float*>(ddt);
  a.dS = static_cast<float*>(dS);
  a.dD_part = static_cast<float*>(dD_part);
  a.B = B;
  a.L = L;
  a.H = H;
  a.Q = Q;
  a.N = N;
  a.P = P;
  a.al_x = a.al_b = a.al_c = al;
  a.al_dy = ssd_tc::aligned16<T>(dy, dy_sb, dy_sr);
  a.al_hin = ssd_tc::aligned16(h_in, 0, 0);
  if (!scratch_ok(a, scratch, scratch_n)) return cudaErrorInvalidValue;
  auto* f = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  return launch_variant<T, true>(a, f, dh_fin != nullptr, s);
}

template <class T>
int split_bwd(const void* x, const void* Bm, const void* Cm, const void* dt, const void* S,
              const void* h_in, const void* dy, const void* dh_fin, void* dx, void* dbc,
              void* ddt, void* dS, void* scratch, long long scratch_n, int B, int L, int H,
              int N, int P, int Q, long long x_sb, long long x_sr, long long b_sb,
              long long b_sr, long long c_sb, long long c_sr, long long dy_sb, long long dy_sr,
              void* stream) {
  if (!geometry_ok(L, N, P, Q) || !ssd_tc::aligned4<T>(x, x_sb, x_sr) ||
      !ssd_tc::aligned4<T>(Bm, b_sb, b_sr) || !ssd_tc::aligned4<T>(Cm, c_sb, c_sr) ||
      !ssd_tc::aligned4<T>(dy, dy_sb, dy_sr))
    return cudaErrorInvalidValue;
  const long long d = static_cast<long long>(H) * P;
  auto* dbcf = static_cast<T*>(dbc);
  Args<T> a{};
  a.x = Operand<T>{static_cast<const T*>(x), x_sb, x_sr};
  a.Bm = Operand<T>{static_cast<const T*>(Bm), b_sb, b_sr};
  a.Cm = Operand<T>{static_cast<const T*>(Cm), c_sb, c_sr};
  a.dy = Operand<T>{static_cast<const T*>(dy), dy_sb, dy_sr};
  a.dt = static_cast<const float*>(dt);
  a.S = static_cast<const float*>(S);
  a.hin = static_cast<const float*>(h_in);
  a.dh_fin = static_cast<const float*>(dh_fin);
  a.dx = Out<T>{static_cast<T*>(dx), L * d, d};
  a.dB = Out<T>{dbcf, 2LL * L * N, 2LL * N};
  a.dC = Out<T>{dbcf + N, 2LL * L * N, 2LL * N};
  a.ddt = static_cast<float*>(ddt);
  a.dS = static_cast<float*>(dS);
  a.B = B;
  a.L = L;
  a.H = H;
  a.Q = Q;
  a.N = N;
  a.P = P;
  a.al_x = ssd_tc::aligned16<T>(x, x_sb, x_sr);
  a.al_b = ssd_tc::aligned16<T>(Bm, b_sb, b_sr);
  a.al_c = ssd_tc::aligned16<T>(Cm, c_sb, c_sr);
  a.al_dy = ssd_tc::aligned16<T>(dy, dy_sb, dy_sr);
  a.al_hin = ssd_tc::aligned16(h_in, 0, 0);
  if (!scratch_ok(a, scratch, scratch_n)) return cudaErrorInvalidValue;
  auto* f = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  return launch_variant<T, false>(a, f, dh_fin != nullptr, s);
}

}  // namespace

extern "C" {

// K9. Inputs: xbc (B, L, d_inner + 2N) with strides (x_sb, x_sr, 1); dt, S
// (B, H, L / Q, Q) contiguous; Dp (H,); h_in (B, L / Q, H, N, P) contiguous;
// dy (B, L, d_inner) with strides (dy_sb, dy_sr, 1).
// Outputs, contiguous: dxbc (B, L, d_inner + 2N), every column written; ddt,
// dS (B, H, L / Q, Q); dD_part (B, H, L / Q, Q / 64), dD_n floats, the
// per-strip partials of dD. scratch: scratch_n floats, 16-byte aligned: G and
// dG (B, L / Q, Q, Q), dh (B, L / Q, H, N, P), the row and column sums of
// dlogM (B, H, L / Q, tile pairs, 64) each, dT and dE (B, H, L) each, and the
// (B, H, L / Q, N P / 1024) partials of sum(dh (.) h_in), in that order.
// Returns a cudaError_t code (cudaErrorInvalidValue for a geometry the kernels
// are not built for: N, P not positive multiples of 128, Q not a multiple of
// 64 up to 8192, L not a multiple of Q; or for a dD_part or scratch size
// other than the geometry's).
int ssd_xbc_bwd(const void* xbc, const void* dt, const void* S, const void* Dp,
                const void* h_in, const void* dy, void* dxbc, void* ddt, void* dS,
                void* dD_part, long long dD_n, void* scratch, long long scratch_n, int B, int L,
                int H, int d_inner, int N, int P, int Q, long long x_sb, long long x_sr,
                long long dy_sb, long long dy_sr, void* stream) {
  return xbc_bwd<float>(xbc, dt, S, Dp, h_in, dy, nullptr, dxbc, ddt, dS, dD_part, dD_n,
                        scratch, scratch_n, B, L, H, d_inner, N, P, Q, x_sb, x_sr, dy_sb, dy_sr,
                        stream);
}

// K9 at bf16: xbc, dy and dxbc bf16 (rows 4-byte aligned), the rest as
// ssd_xbc_bwd's (h_in, dt, S, Dp, ddt, dS, dD_part and the scratch fp32).
int ssd_xbc_bwd_bf16(const void* xbc, const void* dt, const void* S, const void* Dp,
                     const void* h_in, const void* dy, void* dxbc, void* ddt, void* dS,
                     void* dD_part, long long dD_n, void* scratch, long long scratch_n, int B,
                     int L, int H, int d_inner, int N, int P, int Q, long long x_sb,
                     long long x_sr, long long dy_sb, long long dy_sr, void* stream) {
  return xbc_bwd<bf16>(xbc, dt, S, Dp, h_in, dy, nullptr, dxbc, ddt, dS, dD_part, dD_n,
                       scratch, scratch_n, B, L, H, d_inner, N, P, Q, x_sb, x_sr, dy_sb, dy_sr,
                       stream);
}

// K9 seeded: as ssd_xbc_bwd, its dh carry starting at dh_fin (B, H, N, P) fp32
// contiguous, the cotangent of ssd_xbc_fwd_hfin's h_fin.
int ssd_xbc_bwd_seeded(const void* xbc, const void* dt, const void* S, const void* Dp,
                       const void* h_in, const void* dy, const void* dh_fin, void* dxbc,
                       void* ddt, void* dS, void* dD_part, long long dD_n, void* scratch,
                       long long scratch_n, int B, int L, int H, int d_inner, int N, int P,
                       int Q, long long x_sb, long long x_sr, long long dy_sb, long long dy_sr,
                       void* stream) {
  if (dh_fin == nullptr) return cudaErrorInvalidValue;
  return xbc_bwd<float>(xbc, dt, S, Dp, h_in, dy, dh_fin, dxbc, ddt, dS, dD_part, dD_n,
                        scratch, scratch_n, B, L, H, d_inner, N, P, Q, x_sb, x_sr, dy_sb, dy_sr,
                        stream);
}

// ssd_xbc_bwd_seeded at bf16: xbc, dy and dxbc bf16, dh_fin and the rest as
// ssd_xbc_bwd_bf16's.
int ssd_xbc_bwd_seeded_bf16(const void* xbc, const void* dt, const void* S, const void* Dp,
                            const void* h_in, const void* dy, const void* dh_fin, void* dxbc,
                            void* ddt, void* dS, void* dD_part, long long dD_n, void* scratch,
                            long long scratch_n, int B, int L, int H, int d_inner, int N, int P,
                            int Q, long long x_sb, long long x_sr, long long dy_sb,
                            long long dy_sr, void* stream) {
  if (dh_fin == nullptr) return cudaErrorInvalidValue;
  return xbc_bwd<bf16>(xbc, dt, S, Dp, h_in, dy, dh_fin, dxbc, ddt, dS, dD_part, dD_n,
                       scratch, scratch_n, B, L, H, d_inner, N, P, Q, x_sb, x_sr, dy_sb, dy_sr,
                       stream);
}

// K7. Inputs: x (B, L, H * P), Bm, Cm (B, L, N) and dy (B, L, H * P), each
// with its strides (_sb, _sr, 1); dt, S (B, H, L / Q, Q) contiguous; h_in
// (B, L / Q, H, N, P) contiguous, as the forward wrote it; dh_fin (B, H, N, P)
// contiguous, or null for the unseeded variant. Outputs, contiguous: dx
// (B, L, H * P); dbc (B, L, 2N), the head sums dB | dC; ddt, dS
// (B, H, L / Q, Q). scratch as ssd_xbc_bwd's. No D terms. Returns a
// cudaError_t code, as ssd_xbc_bwd.
int ssd_split_bwd(const void* x, const void* Bm, const void* Cm, const void* dt,
                  const void* S, const void* h_in, const void* dy, const void* dh_fin,
                  void* dx, void* dbc, void* ddt, void* dS, void* scratch, long long scratch_n,
                  int B, int L, int H, int N, int P, int Q, long long x_sb, long long x_sr,
                  long long b_sb, long long b_sr, long long c_sb, long long c_sr,
                  long long dy_sb, long long dy_sr, void* stream) {
  return split_bwd<float>(x, Bm, Cm, dt, S, h_in, dy, dh_fin, dx, dbc, ddt, dS, scratch,
                          scratch_n, B, L, H, N, P, Q, x_sb, x_sr, b_sb, b_sr, c_sb, c_sr,
                          dy_sb, dy_sr, stream);
}

// K7 at bf16: x, Bm, Cm, dy, dx and dbc bf16 (rows 4-byte aligned), the rest
// as ssd_split_bwd's.
int ssd_split_bwd_bf16(const void* x, const void* Bm, const void* Cm, const void* dt,
                       const void* S, const void* h_in, const void* dy, const void* dh_fin,
                       void* dx, void* dbc, void* ddt, void* dS, void* scratch,
                       long long scratch_n, int B, int L, int H, int N, int P, int Q,
                       long long x_sb, long long x_sr, long long b_sb, long long b_sr,
                       long long c_sb, long long c_sr, long long dy_sb, long long dy_sr,
                       void* stream) {
  return split_bwd<bf16>(x, Bm, Cm, dt, S, h_in, dy, dh_fin, dx, dbc, ddt, dS, scratch,
                         scratch_n, B, L, H, N, P, Q, x_sb, x_sr, b_sb, b_sr, c_sb, c_sr,
                         dy_sb, dy_sr, stream);
}

const char* ssd_xbc_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

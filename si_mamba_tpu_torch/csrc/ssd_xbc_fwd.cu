// Chunked SSD forward, fp32 or bf16: K8, the boundary-fused forward of the SSD
// mixer, and K6, the split forward of the tensor- and sequence-parallel mixers, one
// body serving both. Per batch row b and head h, with the chunk's inclusive
// log-decay cumsum S (non-increasing) and the state h_in entering the chunk:
//
//   y[t]  = sum_{s<=t} (C[t].B[s]) e^{S[t]-S[s]} dt[s] x[s]
//           + e^{S[t]} C[t] . h_in [+ D x[t]]
//   h_out = e^{S_end} h_in + sum_s B[s] (x) (dt[s] x[s] e^{S_end-S[s]})
//
// K8 (`ssd_xbc_fwd`) replaces the TPU kernel `_make_fwd_kernel_xbc`
// (si_mamba_tpu/ops/pallas/ssd_kernel.py:540) behind `_fwd_call_xbc`
// (`pallas_call` at :602): x, B and C are the column groups [x | B | C] of the
// mixer's un-split conv output xbc (b, l, d + 2n), heads of 128, n = 128,
// with the D x term (kD). The lean variant serves; the training variant also
// writes the state entering every chunk, h_in (b, nc, h, n, p) fp32, for K9.
// `ssd_xbc_fwd_hfin` is K8 behind `_fwd_call_xbc(emit_hfin=True)` (:583, the
// carry of `ssd_chunked_pallas_xbc(return_carry=True)`): either variant that
// also writes the state after the last chunk, h_fin (b, h, n, p) fp32, by
// the kHfin launches K6 runs.
//
// K6 (`ssd_split_fwd`) replaces `_make_fwd_kernel` (ssd_kernel.py:119) behind
// `_fwd_call` (`pallas_call` at :189): x (b, l, h p), B and C (b, l, n) arrive
// as separate operands with their own batch and row strides, as the tensor-
// and sequence-parallel mixers make them (at the tensor-parallel shard x has
// row stride 384 and B, C are the halves of a row-stride-256 buffer), and there
// is no D term. Four variants: with or without h_in, and with or without the
// state after the last chunk, h_fin (b, h, n, p) (kHfin), the sequence-
// parallel carry.
//
// Bound on the H100 at b=32, l=512, q=256, n=p=128: the function needs, per
// batch row, nc (q(q+1) n + h q(q+1) p) for the lower triangles of
// G = C B^T (once for the heads) and of (G (.) M)(dt x), and (nc - 1) h 4qnp
// for C h_in (h_in of the first chunk is 0) and the carry (the last chunk's
// state is read only for h_fin, which adds h 2qnp). K8 (h=6): 7.0 GFLOP
// against 118 MB moved (143 MB with h_in); at the fp32 rate (67 TFLOP/s)
// 0.104 ms; its products run as 3xTF32 on the tensor cores, three products
// for each against 495 TFLOP/s dense TF32: 0.042 ms, about the bytes' 0.035
// ms (0.043 ms with h_in, which then binds). K6 at the tensor-parallel shard
// (h=3): 3.8 GFLOP against 68 MB, 0.023 ms as 3xTF32 (0.056 ms at the fp32
// rate), the bytes binding with h_in (80 MB, 0.024 ms).
//
// What held the earlier design back (grid (h, b), one block walking its chunks in
// series, G per head on CUDA cores), and what this one does about it:
//  1. Too few blocks (192 at B=32 for K8, 96 for K6 at the tensor-parallel
//     shard, one an SM for 182 KB of shared memory, 6 at one cloud). The
//     recurrence is split over chunks, the state-passing form of Mamba-2's
//     SSD, in three launches: (a) `fwd_prep` computes, all in parallel, G of
//     every 64 x 64 lower tile pair of every (b, chunk) into a (b, nc, q, q)
//     scratch, and every chunk's local end state B^T (dt x e^{S_end - S})
//     into h_in's slot c + 1 (the last chunk's into h_fin, with kHfin); (b)
//     `fwd_carry`, for nc > 2 (nc > 1 with kHfin), walks the chunks in one
//     launch, h_in[c] += e^{S_end[c-1]} h_in[c-1], elementwise on the
//     128 x 128 state, and then h_fin += e^{S_end} h_in[nc-1]; (c) `fwd_y`,
//     one block a (b, chunk, 64-row strip, head),
//     y = [(G (.) M) dt | e^S C] [x ; h_in] [+ D x] as one product of depth
//     (strip end) + n. At B=32 and 6 heads the launches run 1024 and 1536
//     blocks, at one cloud 32 and 48; 86 KB of shared memory, two blocks an
//     SM.
//  2. 2.1x the products the function needs. G is computed once per
//     (b, chunk), and never above the diagonal tiles; C h_in is skipped in
//     the first chunk and the end state in the last (unless h_fin is
//     wanted); a warp skips a k-tile whose (G (.) M) rows are all masked.
//  3. fp32 FFMA at 15 TFLOP/s. Every product is 3xTF32 mma.sync
//     (csrc/ssd_tc.cuh), fed by a three-stage cp.async ring, so the next
//     tiles land while the current one's products run.
// The decay mask is applied to G's tile as it lands: e^{S[t]-S[s]} dt[s] for
// s <= t (every exponent <= 0), 0 otherwise, never exponentiated. The lean
// and training variants run the same launches (the lean one into a scratch
// that holds h_in's slots 1 .. nc - 1, the ones it reads), so their y are
// bitwise equal. No atomics, no fast math. Rows that are not 16-byte aligned
// land by 4-byte cp.async copies, chosen per operand.
//
// bf16 (the `_bf16` entry points): x, B and C arrive and y leaves in bf16,
// as the TPU kernels take them at bf16 activations (`mm`, ssd_kernel.py:
// 493-494, 802-803), and every product whose operands they round to bf16 is a
// bf16 tensor-core product with fp32 accumulators (csrc/ssd_tc.cuh): G = C B^T
// (kept in fp32), (G (.) M) rounded to bf16 times xdt = bf16(x dt), C times
// bf16(h_in) (then scaled by e^S, not before), and B^T times
// xdt_dec = bf16(xdt e^{S_end - S}), a second rounding of the rounded xdt,
// where `_make_fwd_kernel(_xbc)` round. The decay factors, the chunk carry,
// the states written out and h_fin stay fp32. The fp32 body's products and
// launches are unchanged: each element type is its own instantiation.
//
// Wide states (the kWide instantiation): d_state n and head_dim p any
// multiples of 128, the shapes `ssd_fused_supported` (ssd_kernel.py:70)
// compiles the TPU kernels for. The output tile stays 64 x 128 and the shared
// memory stays as it is; wider states take more tiles and deeper k-loops:
// fwd_prep's chunk end states are (n / 64) x (p / 128) tiles, one block each
// (the grid gains the tile index rather than a block looping over its tiles:
// at B=32, L=512, q=256, n = p = 256 and 3 heads that gives 768 blocks beside
// G's 640, where a loop would leave 192, under one a SM's two); y is p / 128
// column tiles, one block each; the contractions over n (G = C B^T and
// C h_in) run n / 32 k-tiles; fwd_carry stays elementwise, n p / 1024 blocks
// a (b, h). n = p = 128 is its own instantiation (kWide false), with n and p
// compile-time constants, as it was built before the wide one existed.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "ssd_tc.cuh"

namespace {

using ssd_tc::Acc;
using ssd_tc::AllActive;
using ssd_tc::for_each;
using ssd_tc::g_tile;
using ssd_tc::gemm;
using ssd_tc::is_bf16;
using ssd_tc::kBK;
using ssd_tc::kBM;
using ssd_tc::kRingFloats;
using ssd_tc::kThreads;
using ssd_tc::NoXform;
using ssd_tc::pair_tiles;
using ssd_tc::Src;
using ssd_tc::zero;

constexpr int kN = 128;         // d_state of the tuned instantiation
constexpr int kP = 128;         // head_dim of the tuned instantiation
constexpr int kTile = 128;      // d_state and head_dim are multiples of this
constexpr int kArrayFloor = 256;  // the per-chunk shared arrays' least length
constexpr int kMaxChunk = 8192;   // the longest chunk the dynamic shared memory holds

// The blocks a (b, h) of fwd_carry: 4 state elements a thread (16 at
// n = p = 128).
int carry_parts(int N, int P) {
  return static_cast<int>(static_cast<long long>(N) * P / (kThreads * 4));
}

// The per-chunk shared arrays' length for chunk Q (up to 256 the length they
// always had, so the shared memory of those chunks is unchanged), and the
// dynamic shared memory of fwd_prep and fwd_y.
int array_len(int Q) { return Q > kArrayFloor ? Q : kArrayFloor; }
int smem_bytes(int QS) { return static_cast<int>(sizeof(float)) * (kRingFloats + 3 * QS); }

// One operand of element type T: base pointer (at its first column) and the
// batch and row strides in elements.
template <class T>
struct Operand {
  const T* p;
  long long sb, sr;
};

bool geometry_ok(int L, int N, int P, int Q) {
  return N > 0 && P > 0 && N % kTile == 0 && P % kTile == 0 && Q % kBM == 0 && Q > 0 && Q <= kMaxChunk && L % Q == 0;
}

// The operands and outputs of one forward: x, B and C (T) with their batch and
// row strides (x at head 0's first column), al_* when their rows are 16-byte
// aligned; dt, S (b, h, L) fp32; Dp (h) for kD; y (b, L, h p) T contiguous;
// hin (b, nc - slot0, h, n, p) fp32, the slots slot0 .. nc - 1 of h_in: h_in
// itself (slot0 0) or the lean forward's scratch (slot0 1: the first chunk's
// state is 0 and read by nothing); G (b, nc, q, q) fp32 scratch; h_fin
// (b, h, n, p) fp32 for kHfin.
template <class T>
struct Args {
  Operand<T> x, Bm, Cm;
  const float* dt;
  const float* S;
  const float* Dp;
  T* y;
  float* hin;
  float* G;
  float* h_fin;
  int B, L, H, Q, slot0;
  int N, P;  // d_state and head_dim, read by the wide instantiation only
  int QS;    // the per-chunk shared arrays' length, array_len(Q)
  bool al_x, al_b, al_c;
};

// d_state and head_dim in a kernel: 128 each, fixed at compile time, in the
// tuned instantiation (kWide false); the launch's multiples of 128 in the
// wide one.
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

template <bool kWide, class T>
__device__ __forceinline__ float* slot(const Args<T>& a, int b, int c, int h) {
  const int held = a.L / a.Q - a.slot0;
  return a.hin + ((static_cast<long long>(b) * held + c - a.slot0) * a.H + h) * np_of<kWide>(a);
}

// Blocks [0, B nc pairs): one G tile pair each. The rest: one (b, h, chunk,
// 64 x 128 tile of the (n, p) state: a 64-row half of n at n = 128) each, the
// chunk's local end state B^T (dt x e^{S_end - S}), for every chunk whose
// state is read (all but the last; all with kHfin), into h_in's slot c + 1
// (h_fin for the last chunk). fp32: 3xTF32, the factor on B's tile; bf16:
// B^T bf16(bf16(x dt) e^{S_end - S}), the factors and roundings on x's tile.
template <class T, bool kHfin, bool kWide>
__global__ void __launch_bounds__(kThreads, 2) fwd_prep(Args<T> a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sF = smem + kRingFloats;
  float* sTe = sF + a.QS;
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
  const int nstate = kHfin ? nc : nc - 1;
  const int P = p_of<kWide>(a), halves = n_of<kWide>(a) / kBM, tiles = halves * (P / kTile);
  const int tile = bid % tiles, half = tile % halves, pt = tile / halves;
  bid /= tiles;
  const int h = bid % a.H, c = bid / a.H % nstate, b = bid / a.H / nstate;
  const long long bh = static_cast<long long>(b) * a.H + h, r0 = static_cast<long long>(c) * a.Q;
  const float* Sc = a.S + bh * a.L + r0;
  const float* dtc = a.dt + bh * a.L + r0;
  const float send = Sc[a.Q - 1];
  for (int i = threadIdx.x; i < a.Q; i += kThreads) {
    if (is_bf16<T>) {
      sF[i] = dtc[i];
      sTe[i] = expf(send - Sc[i]);
    } else {
      sF[i] = dtc[i] * expf(send - Sc[i]);
    }
  }
  Acc<128> acc;
  zero<128>(acc);
  const T* Bc = a.Bm.p + b * a.Bm.sb + r0 * a.Bm.sr + half * kBM;
  const T* xc = a.x.p + b * a.x.sb + r0 * a.x.sr + h * P + pt * kTile;
  const long long bsr = a.Bm.sr, xsr = a.x.sr;
  const bool alb = a.al_b, alx = a.al_x;
  auto src_b = [=](int kt) { return Src<T>{Bc + kt * kBK * bsr, bsr, alb}; };
  auto src_x = [=](int kt) { return Src<T>{xc + kt * kBK * xsr, xsr, alx}; };
  if constexpr (is_bf16<T>) {
    gemm<128, true, false, true, T, T>(
        acc, ring, a.Q / kBK, src_b, src_x, NoXform{},
        [=](int kt, int k, int, float v) {
          const int s = kt * kBK + k;
          return round_to<bf16>(round_to<bf16>(v * sF[s]) * sTe[s]);
        },
        AllActive{});
  } else {
    gemm<128, true, false, false, T, T>(
        acc, ring, a.Q / kBK, src_b, src_x,
        [=](int kt, int, int k, float v) { return v * sF[kt * kBK + k]; }, NoXform{},
        AllActive{});
  }
  float* dst = (c + 1 < nc ? slot<kWide>(a, b, c + 1, h) : a.h_fin + bh * np_of<kWide>(a)) +
               half * kBM * P + pt * kTile;
  for_each<128>(acc, [=](int m, int n, float v) { dst[m * P + n] = v; });
}

// h_in[c] = e^{S_end[c-1]} h_in[c-1] + (the local state in slot c) for
// c = 2 .. nc - 1 (slot 1 already holds h_in[1]); with kHfin then
// h_fin += e^{S_end[nc-1]} h_in[nc-1]. Grid (B h, carry_parts(n, p)), 4
// elements a thread, fp32 at either element type.
template <class T, bool kHfin, bool kWide>
__global__ void __launch_bounds__(kThreads) fwd_carry(Args<T> a) {
  const int nc = a.L / a.Q;
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / a.H), h = static_cast<int>(bh % a.H);
  const float* Sb = a.S + bh * a.L;
  const int e0 = blockIdx.y * kThreads * 4 + threadIdx.x;
  float prev[4];
  const float* first = slot<kWide>(a, b, 1, h);
#pragma unroll
  for (int j = 0; j < 4; ++j) prev[j] = first[e0 + j * kThreads];
  for (int c = 2; c < nc; ++c) {
    const float decay = expf(Sb[static_cast<long long>(c) * a.Q - 1]);
    float* sc = slot<kWide>(a, b, c, h);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = decay * prev[j] + sc[e0 + j * kThreads];
      sc[e0 + j * kThreads] = v;
      prev[j] = v;
    }
  }
  if (kHfin) {
    const float decay = expf(Sb[a.L - 1]);
    float* hf = a.h_fin + bh * np_of<kWide>(a);
#pragma unroll
    for (int j = 0; j < 4; ++j) hf[e0 + j * kThreads] += decay * prev[j];
  }
}

// One (b, chunk, 64-row strip, 128 columns of the head, head) a block, the
// longest strips first: y = (G (.) M) (dt x) + e^S C h_in [+ D x]. With
// kStates the first chunk's blocks also write h_in[0] = 0. fp32:
// [(G (.) M) dt | e^S C] [x ; h_in] as 3xTF32, the factors on the A tiles;
// bf16: e^S (C bf16(h_in)), then bf16(G (.) M) bf16(x dt) into the same
// accumulator, bf16 products.
template <class T, bool kStates, bool kD, bool kWide>
__global__ void __launch_bounds__(kThreads, 2) fwd_y(Args<T> a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sS = smem + kRingFloats;
  float* sdt = sS + a.QS;
  float* sE = sdt + a.QS;
  const int nc = a.L / a.Q, T_ = a.Q / kBM;
  const int N = n_of<kWide>(a), P = p_of<kWide>(a), PT = P / kTile;
  int bid = blockIdx.x;
  const int h = bid % a.H;
  bid /= a.H;
  const int pt = bid % PT;
  bid /= PT;
  const int ts = T_ - 1 - bid % T_;
  bid /= T_;
  const int c = bid % nc, b = bid / nc;
  const long long bh = static_cast<long long>(b) * a.H + h, r0 = static_cast<long long>(c) * a.Q;
  for (int i = threadIdx.x; i < a.Q; i += kThreads) {
    const float s = a.S[bh * a.L + r0 + i];
    sS[i] = s;
    sdt[i] = a.dt[bh * a.L + r0 + i];
    sE[i] = expf(s);
  }
  const int t0 = ts * kBM;
  Acc<128> acc;
  zero<128>(acc);
  if (c > 0) {  // e^S C h_in; h_in of the first chunk is 0
    const T* Ct = a.Cm.p + b * a.Cm.sb + (r0 + t0) * a.Cm.sr;
    const float* hc = slot<kWide>(a, b, c, h) + pt * kTile;
    const long long csr = a.Cm.sr;
    const bool alc = a.al_c;
    auto src_c = [=](int kt) { return Src<T>{Ct + kt * kBK, csr, alc}; };
    auto src_h = [=](int kt) { return Src<float>{hc + kt * kBK * P, P, true}; };
    if constexpr (is_bf16<T>) {
      gemm<128, false, false, true, T, float>(acc, ring, N / kBK, src_c, src_h, NoXform{},
                                              NoXform{}, AllActive{});
      for_each<128>(acc, [=](int m, int, float& v) { v *= sE[t0 + m]; });
    } else {
      gemm<128, false, false, false, T, float>(
          acc, ring, N / kBK, src_c, src_h,
          [=](int, int m, int, float v) { return v * sE[t0 + m]; }, NoXform{}, AllActive{});
    }
  }
  const long long Q = a.Q;
  const float* Gt = a.G + (static_cast<long long>(b) * nc + c) * Q * Q + t0 * Q;
  const T* xc = a.x.p + b * a.x.sb + r0 * a.x.sr + h * P + pt * kTile;
  const long long xsr = a.x.sr;
  const bool alx = a.al_x;
  auto src_g = [=](int kt) { return Src<float>{Gt + kt * kBK, Q, true}; };
  auto src_x = [=](int kt) { return Src<T>{xc + kt * kBK * xsr, xsr, alx}; };
  auto active = [=](int kt, int wm) { return kt * kBK <= t0 + wm * 32 + 31; };
  if constexpr (is_bf16<T>) {
    gemm<128, false, false, true, float, T>(
        acc, ring, (t0 + kBM) / kBK, src_g, src_x,
        [=](int kt, int m, int k, float v) {
          const int t = t0 + m, s = kt * kBK + k;
          return s <= t ? v * expf(sS[t] - sS[s]) : 0.f;
        },
        [=](int kt, int k, int, float v) { return v * sdt[kt * kBK + k]; }, active);
  } else {
    gemm<128, false, false, false, float, T>(
        acc, ring, (t0 + kBM) / kBK, src_g, src_x,
        [=](int kt, int m, int k, float v) {
          const int t = t0 + m, s = kt * kBK + k;
          return s <= t ? v * expf(sS[t] - sS[s]) * sdt[s] : 0.f;
        },
        NoXform{}, active);
  }
  const float skip = kD ? a.Dp[h] : 0.f;
  const long long d = static_cast<long long>(a.H) * P;
  T* yt = a.y + (b * static_cast<long long>(a.L) + r0 + t0) * d + h * P + pt * kTile;
  const T* xt = xc + t0 * xsr;
  for_each<128>(acc, [=](int m, int n, float v) {
    yt[m * d + n] = from_f<T>(kD ? v + skip * to_f(xt[m * xsr + n]) : v);
  });
  if (kStates && c == 0) {  // block (ts, pt) zeroes its share of h_in[0], [e0, e1)
    float* z = slot<kWide>(a, b, 0, h);
    const long long np = np_of<kWide>(a), parts = T_ * PT, part = ts * PT + pt;
    const long long e0 = part * np / parts, e1 = (part + 1) * np / parts;
    for (long long i = e0 + threadIdx.x; i < e1; i += kThreads) z[i] = 0.f;
  }
}

template <class K>
cudaError_t allow_smem(K* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <class T, bool kStates, bool kHfin, bool kD, bool kWide>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const int smem = smem_bytes(a.QS);
  const int nc = a.L / a.Q, T_ = a.Q / kBM, tiles = a.N / kBM * (a.P / kTile);
  cudaError_t err = allow_smem(fwd_prep<T, kHfin, kWide>, smem);
  if (err == cudaSuccess) err = allow_smem(fwd_y<T, kStates, kD, kWide>, smem);
  if (err != cudaSuccess) return err;
  const int n_prep = a.B * nc * T_ * (T_ + 1) / 2 + a.B * a.H * (kHfin ? nc : nc - 1) * tiles;
  if (n_prep > 0) {
    fwd_prep<T, kHfin, kWide><<<n_prep, kThreads, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (nc > 2 || (kHfin && nc > 1)) {
    fwd_carry<T, kHfin, kWide>
        <<<dim3(a.B * a.H, carry_parts(a.N, a.P)), kThreads, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  fwd_y<T, kStates, kD, kWide><<<a.B * nc * T_ * (a.P / kTile) * a.H, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class T, bool kD, bool kWide>
cudaError_t launch_variant(const Args<T>& a, bool states, bool hfin, cudaStream_t s) {
  if (states)
    return hfin ? launch<T, true, true, kD, kWide>(a, s) : launch<T, true, false, kD, kWide>(a, s);
  return hfin ? launch<T, false, true, kD, kWide>(a, s) : launch<T, false, false, kD, kWide>(a, s);
}

// Checks the scratch against the geometry, then launches the variant that
// states (h_in itself in a.hin, else the lean scratch of slots 1 .. nc - 1)
// and a.h_fin (written unless null) name: the tuned instantiation at
// n = p = 128, the wide one at any other multiples of 128.
template <class T, bool kD>
int checked_launch(Args<T> a, long long hin_n, bool states, long long g_n, cudaStream_t s) {
  const long long nc = a.L / a.Q;
  a.slot0 = states ? 0 : 1;
  a.QS = array_len(a.Q);
  if (hin_n != a.B * (nc - a.slot0) * a.H * static_cast<long long>(a.N) * a.P ||
      g_n != a.B * nc * a.Q * a.Q || !ssd_tc::aligned16(a.hin, 0, 0) ||
      !ssd_tc::aligned16(a.G, 0, 0))
    return cudaErrorInvalidValue;
  const bool hfin = a.h_fin != nullptr;
  if (a.N == kN && a.P == kP) return launch_variant<T, kD, false>(a, states, hfin, s);
  return launch_variant<T, kD, true>(a, states, hfin, s);
}

template <class T>
int xbc_fwd(const void* xbc, const void* dt, const void* S, const void* Dp, void* y, void* hin,
            long long hin_n, int states, void* h_fin, void* G, long long g_n, int B, int L,
            int H, int d_inner, int N, int P, int Q, long long x_sb, long long x_sr,
            void* stream) {
  if (!geometry_ok(L, N, P, Q) || d_inner != H * P || !ssd_tc::aligned4<T>(xbc, x_sb, x_sr))
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const T*>(xbc);
  const bool al = ssd_tc::aligned16<T>(xf, x_sb, x_sr);
  Args<T> a{};
  a.x = Operand<T>{xf, x_sb, x_sr};
  a.Bm = Operand<T>{xf + d_inner, x_sb, x_sr};
  a.Cm = Operand<T>{xf + d_inner + N, x_sb, x_sr};
  a.dt = static_cast<const float*>(dt);
  a.S = static_cast<const float*>(S);
  a.Dp = static_cast<const float*>(Dp);
  a.y = static_cast<T*>(y);
  a.hin = static_cast<float*>(hin);
  a.G = static_cast<float*>(G);
  a.h_fin = static_cast<float*>(h_fin);
  a.B = B;
  a.L = L;
  a.H = H;
  a.Q = Q;
  a.N = N;
  a.P = P;
  a.al_x = a.al_b = a.al_c = al;
  return checked_launch<T, true>(a, hin_n, states != 0, g_n, static_cast<cudaStream_t>(stream));
}

template <class T>
int split_fwd(const void* x, const void* Bm, const void* Cm, const void* dt, const void* S,
              void* y, void* hin, long long hin_n, int states, void* h_fin, void* G,
              long long g_n, int B, int L, int H, int N, int P, int Q, long long x_sb,
              long long x_sr, long long b_sb, long long b_sr, long long c_sb, long long c_sr,
              void* stream) {
  if (!geometry_ok(L, N, P, Q) || !ssd_tc::aligned4<T>(x, x_sb, x_sr) ||
      !ssd_tc::aligned4<T>(Bm, b_sb, b_sr) || !ssd_tc::aligned4<T>(Cm, c_sb, c_sr))
    return cudaErrorInvalidValue;
  Args<T> a{};
  a.x = Operand<T>{static_cast<const T*>(x), x_sb, x_sr};
  a.Bm = Operand<T>{static_cast<const T*>(Bm), b_sb, b_sr};
  a.Cm = Operand<T>{static_cast<const T*>(Cm), c_sb, c_sr};
  a.dt = static_cast<const float*>(dt);
  a.S = static_cast<const float*>(S);
  a.y = static_cast<T*>(y);
  a.hin = static_cast<float*>(hin);
  a.G = static_cast<float*>(G);
  a.h_fin = static_cast<float*>(h_fin);
  a.B = B;
  a.L = L;
  a.H = H;
  a.Q = Q;
  a.N = N;
  a.P = P;
  a.al_x = ssd_tc::aligned16<T>(x, x_sb, x_sr);
  a.al_b = ssd_tc::aligned16<T>(Bm, b_sb, b_sr);
  a.al_c = ssd_tc::aligned16<T>(Cm, c_sb, c_sr);
  return checked_launch<T, false>(a, hin_n, states != 0, g_n, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// K8. xbc: (B, L, d_inner + 2N) fp32 with strides (x_sb, x_sr, 1); dt, S:
// (B, H, L / Q, Q) contiguous; Dp: (H,); y: (B, L, d_inner) contiguous;
// hin: contiguous, 16-byte aligned, hin_n floats: h_in (B, L / Q, H, N, P)
// itself when states is 1, else a scratch (B, L / Q - 1, H, N, P) for the
// states entering chunks 1 .. L / Q - 1; G: a (B, L / Q, Q, Q)
// scratch of g_n floats, 16-byte aligned. Returns a cudaError_t code
// (cudaErrorInvalidValue for a geometry the kernels are not built for: N, P
// not positive multiples of 128, Q not a multiple of 64 up to 8192, L not a multiple of Q,
// d_inner other than H * P; or for a scratch size other than the geometry's).
int ssd_xbc_fwd(const void* xbc, const void* dt, const void* S, const void* Dp, void* y,
                void* hin, long long hin_n, int states, void* G, long long g_n, int B, int L,
                int H, int d_inner, int N, int P, int Q, long long x_sb, long long x_sr,
                void* stream) {
  return xbc_fwd<float>(xbc, dt, S, Dp, y, hin, hin_n, states, nullptr, G, g_n, B, L, H,
                        d_inner, N, P, Q, x_sb, x_sr, stream);
}

// K8 at bf16: xbc and y bf16, every other argument as ssd_xbc_fwd's (dt, S, Dp
// and the states fp32); xbc's rows must start 4-byte aligned.
int ssd_xbc_fwd_bf16(const void* xbc, const void* dt, const void* S, const void* Dp, void* y,
                     void* hin, long long hin_n, int states, void* G, long long g_n, int B,
                     int L, int H, int d_inner, int N, int P, int Q, long long x_sb,
                     long long x_sr, void* stream) {
  return xbc_fwd<bf16>(xbc, dt, S, Dp, y, hin, hin_n, states, nullptr, G, g_n, B, L, H,
                       d_inner, N, P, Q, x_sb, x_sr, stream);
}

// K8 with the carry: as ssd_xbc_fwd (lean, or with states), and h_fin
// (B, H, N, P) fp32 contiguous, the state after the last chunk from a zero
// start, written.
int ssd_xbc_fwd_hfin(const void* xbc, const void* dt, const void* S, const void* Dp, void* y,
                     void* hin, long long hin_n, int states, void* h_fin, void* G,
                     long long g_n, int B, int L, int H, int d_inner, int N, int P, int Q,
                     long long x_sb, long long x_sr, void* stream) {
  if (h_fin == nullptr) return cudaErrorInvalidValue;
  return xbc_fwd<float>(xbc, dt, S, Dp, y, hin, hin_n, states, h_fin, G, g_n, B, L, H,
                        d_inner, N, P, Q, x_sb, x_sr, stream);
}

// ssd_xbc_fwd_hfin at bf16: xbc and y bf16, h_fin and the rest as
// ssd_xbc_fwd_bf16's.
int ssd_xbc_fwd_hfin_bf16(const void* xbc, const void* dt, const void* S, const void* Dp,
                          void* y, void* hin, long long hin_n, int states, void* h_fin, void* G,
                          long long g_n, int B, int L, int H, int d_inner, int N, int P, int Q,
                          long long x_sb, long long x_sr, void* stream) {
  if (h_fin == nullptr) return cudaErrorInvalidValue;
  return xbc_fwd<bf16>(xbc, dt, S, Dp, y, hin, hin_n, states, h_fin, G, g_n, B, L, H,
                       d_inner, N, P, Q, x_sb, x_sr, stream);
}

// K6. x: (B, L, H * P) with strides (x_sb, x_sr, 1); Bm, Cm: (B, L, N) with
// strides (b_sb, b_sr, 1) and (c_sb, c_sr, 1); dt, S: (B, H, L / Q, Q)
// contiguous; y: (B, L, H * P) contiguous; hin and G the scratch of
// ssd_xbc_fwd, with the same sizes and the same states flag; h_fin:
// (B, H, N, P) contiguous, written, or null for the variants without it. No D
// term. Returns a cudaError_t code, as ssd_xbc_fwd.
int ssd_split_fwd(const void* x, const void* Bm, const void* Cm, const void* dt,
                  const void* S, void* y, void* hin, long long hin_n, int states, void* h_fin,
                  void* G, long long g_n, int B, int L, int H, int N, int P, int Q,
                  long long x_sb, long long x_sr, long long b_sb, long long b_sr,
                  long long c_sb, long long c_sr, void* stream) {
  return split_fwd<float>(x, Bm, Cm, dt, S, y, hin, hin_n, states, h_fin, G, g_n, B, L, H, N,
                          P, Q, x_sb, x_sr, b_sb, b_sr, c_sb, c_sr, stream);
}

// K6 at bf16: x, Bm, Cm and y bf16 (rows 4-byte aligned), the rest as
// ssd_split_fwd's.
int ssd_split_fwd_bf16(const void* x, const void* Bm, const void* Cm, const void* dt,
                       const void* S, void* y, void* hin, long long hin_n, int states,
                       void* h_fin, void* G, long long g_n, int B, int L, int H, int N, int P,
                       int Q, long long x_sb, long long x_sr, long long b_sb, long long b_sr,
                       long long c_sb, long long c_sr, void* stream) {
  return split_fwd<bf16>(x, Bm, Cm, dt, S, y, hin, hin_n, states, h_fin, G, g_n, B, L, H, N, P,
                         Q, x_sb, x_sr, b_sb, b_sr, c_sb, c_sr, stream);
}

const char* ssd_xbc_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Chunked SSD forward, fp32: K8, the boundary-fused forward of the SSD mixer,
// and K6, the split forward of the tensor- and sequence-parallel mixers. Per
// batch row b and head h, with the chunk's inclusive log-decay cumsum S
// (non-increasing) and the state h_in entering the chunk:
//
//   y[t]  = sum_{s<=t} (C[t].B[s]) e^{S[t]-S[s]} dt[s] x[s]
//           + e^{S[t]} C[t] . h_in [+ D x[t]]
//   h_out = e^{S_end} h_in + sum_s B[s] (x) (dt[s] x[s] e^{S_end-S[s]})
//
// K8 (`ssd_xbc_fwd`) replaces the TPU kernel `_make_fwd_kernel_xbc`
// (si_mamba_tpu/ops/pallas/ssd_kernel.py:540) behind `_fwd_call_xbc`
// (`pallas_call` at :602): x, B and C are the column groups [x | B | C] of the
// mixer's un-split conv output xbc (b, l, d + 2n), heads of 128, n = 128.
// The lean variant serves; the training variant also writes the state
// entering every chunk, h_in (b, nc, h, n, p) fp32, for K9.
//
// Bound on the H100 at b=32, l=512, q=256, h=6, n=p=128: the function needs,
// per batch row, nc (q(q+1) n + h q(q+1) p) for the lower triangles of
// G = C B^T (once for the heads) and of (G (.) M)(dt x), and (nc - 1) h 4qnp
// for C h_in (h_in of the first chunk is 0) and the carry (the last chunk's
// state is not read): 7.0 GFLOP, against 118 MB moved (143 MB with h_in). At
// the fp32 rate (67 TFLOP/s) that is 0.104 ms. This design runs its products
// as 3xTF32 on the tensor cores, three products for each against 495
// TFLOP/s dense TF32: 0.042 ms, about the bytes' 0.035 ms (0.043 ms with
// h_in, which then binds).
//
// What held the earlier design back (grid (h, b), one block walking its chunks
// in series, G per head on CUDA cores; kept below for K6 only), and what this
// one does about it:
//  1. Too few blocks (192 at B=32, one an SM for 182 KB of shared memory, 6 at
//     one cloud). The recurrence is split over chunks, the state-passing form
//     of Mamba-2's SSD, in three launches: (a) `fwd_prep` computes, all in
//     parallel, G of every 64 x 64 lower tile pair of every (b, chunk) into a
//     (b, nc, q, q) scratch, and every chunk's local end state
//     B^T (dt x e^{S_end - S}) into h_in's slot c + 1; (b) `fwd_carry`, only
//     for nc > 2, walks the chunks in one launch, h_in[c] += e^{S_end[c-1]}
//     h_in[c-1], elementwise on the 128 x 128 state; (c) `fwd_y`, one block a
//     (b, chunk, 64-row strip, head), y = [(G (.) M) dt | e^S C] [x ; h_in] +
//     D x as one product of depth (strip end) + n. At B=32 the launches run
//     1024 and 1536 blocks, at one cloud 32 and 48; 86 KB of shared memory,
//     two blocks an SM.
//  2. 2.1x the products the function needs. G is computed once per
//     (b, chunk), and never above the diagonal tiles; C h_in is skipped in
//     the first chunk and the end state in the last; a warp skips a k-tile
//     whose (G (.) M) rows are all masked.
//  3. fp32 FFMA at 15 TFLOP/s. Every product is 3xTF32 mma.sync
//     (csrc/ssd_tc.cuh), fed by a three-stage cp.async ring, so the next
//     tiles land while the current one's products run.
// The decay mask is applied to G's tile as it lands: e^{S[t]-S[s]} dt[s] for
// s <= t (every exponent <= 0), 0 otherwise, never exponentiated. The lean
// and training variants run the same launches (the lean one into a scratch
// that holds h_in's slots 1 .. nc - 1, the ones it reads), so their y are
// bitwise equal. No atomics, no fast math.
//
// The body takes x, B and C as separate operands with their own batch and row
// strides, and template flags for the D x term (kD) and the state after the
// last chunk (kHfin), for K6's move onto it. Only K8's two variants run and
// are tested; K6's four (kD false, with and without kHfin) are instantiated
// at the end of the body, so the compiler checks them, but have never run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "ssd_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// K6: the earlier one-block-a-(batch, head) body, which serves the split
// forward (`ssd_split_fwd`) only, until K6's own change moves it onto the
// chunk-parallel body below and tests its variants there. It
// replaces `_make_fwd_kernel` behind `_fwd_call` (ssd_kernel.py:119, :189),
// whose operands arrive split, as the tensor- and sequence-parallel mixers
// make them. The TPU kernel's grid is (b, nc) with the chunk axis sequential
// and the (h, n, p) state in VMEM scratch; here a loop inside the block takes
// the place of the sequential chunk axis.
//
// K6 at the tensor-parallel shard (3 heads a rank at TP = 2) executes about
// twice the products it needs (G per head, whole diagonal tiles, both
// (q, n, p) products in every chunk) on CUDA cores, and its grid of
// 3 x 32 = 96 blocks leaves 36 of the 132 SMs idle.
//
// Design: grid (h, b), 256 threads a block; each block owns one (b, h) and
// walks its chunks in order with the 128 x 128 state in shared memory. For
// each chunk:
//  1. y, one strip of 64 time rows at a time: the strip's C rows are staged
//     in shared memory; for each 64-row tile of earlier-or-equal rows s, the
//     tile's B rows and dt x rows are staged, the 64 x 64 tile of
//     G (.) e^{S[t]-S[s]} is computed (tiles with s > t are skipped, and in
//     the diagonal tile entries with s > t are set to 0, never exponentiated),
//     and its product with dt x is added to registers. Then C h_in e^{S[t]}
//     is added and y is written.
//  2. the state: B^T (dt x e^{S_end-S}) over 64-row tiles into 64 registers
//     a thread, then h <- e^{S_end} h + that, in place. After the last chunk
//     kHfin copies it out.
// x (b, l, h p), B and C (b, l, n) each come with their own batch and row
// strides; there is no D term. Template flags: kStates also writes h_in,
// kHfin the state after the last chunk. Each thread owns
// a 4 x 8 (strip) or 8 x 8 (state) block of the output with the columns 16
// apart; rows read along their length are padded to 129 floats. CUDA cores
// only. Shared memory: 182,784 bytes.

constexpr int kThreads = 256;
constexpr int kStrip = 64;      // time rows of a strip / tile
constexpr int kN = 128;         // d_state
constexpr int kP = 128;         // head_dim
constexpr int kMaxChunk = 256;  // the longest chunk sS / sdt hold
constexpr int kLd = 129;        // padded row stride of tiles read along their rows
constexpr int kLdW = 65;        // padded row stride of the (t, s) tile

constexpr int kSmemFloats = kN * kP                // state
                            + 2 * kStrip * kLd     // C strip, B tile
                            + kStrip * kP          // dt x tile
                            + kStrip * kLdW        // (t, s) tile
                            + 2 * kMaxChunk;       // S, dt of the chunk

// One operand of the kernel: base pointer (at its first column) and the
// batch and row strides in floats.
struct Operand {
  const float* p;
  long long sb, sr;
};

template <bool kStates, bool kHfin>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_kernel(Operand x, Operand Bm, Operand Cm, const float* __restrict__ dt,
               const float* __restrict__ S, float* __restrict__ y, float* __restrict__ h_in,
               float* __restrict__ h_fin, int L, int H, int Q) {
  extern __shared__ float smem[];
  float* hc = smem;                   // [kN][kP]
  float* sC = hc + kN * kP;           // [kStrip][kLd]
  float* sB = sC + kStrip * kLd;      // [kStrip][kLd]
  float* sX = sB + kStrip * kLd;      // [kStrip][kP]
  float* sW = sX + kStrip * kP;       // [kStrip][kLdW]
  float* sS = sW + kStrip * kLdW;     // [kMaxChunk]
  float* sdt = sS + kMaxChunk;        // [kMaxChunk]

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // 0..15: row group
  const int tx = tid & 15;  // 0..15: column, 16 apart
  const int nc = L / Q;
  const int n_strips = Q / kStrip;
  const int d = H * kP;
  const float* xb = x.p + static_cast<long long>(b) * x.sb + head * kP;
  const long long b_sr = Bm.sr, c_sr = Cm.sr;
  const float* Bb = Bm.p + static_cast<long long>(b) * Bm.sb;
  const float* Cb = Cm.p + static_cast<long long>(b) * Cm.sb;
  const long long bh = static_cast<long long>(b) * H + head;
  const float* dtb = dt + bh * L;  // (b, h, nc, q) is (b, h, L)
  const float* Sb = S + bh * L;
  float* yb = y + static_cast<long long>(b) * L * d + head * kP;

  for (int i = tid; i < kN * kP; i += kThreads) hc[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int r0 = c * Q;
    __syncthreads();  // the previous chunk's state update and reads are done
    for (int i = tid; i < Q; i += kThreads) {
      sS[i] = Sb[r0 + i];
      sdt[i] = dtb[r0 + i];
    }
    if (kStates) {
      float* hout = h_in + ((static_cast<long long>(b) * nc + c) * H + head) * kN * kP;
      for (int i = tid; i < kN * kP; i += kThreads) hout[i] = hc[i];
    }
    __syncthreads();

    // ---- 1. y, strip by strip --------------------------------------------
    for (int ts = 0; ts < n_strips; ++ts) {
      const int t0 = ts * kStrip;
      for (int i = tid; i < kStrip * kN; i += kThreads) {
        const int r = i / kN, k = i % kN;
        sC[r * kLd + k] = Cb[(r0 + t0 + r) * c_sr + k];
      }
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      for (int ss = 0; ss <= ts; ++ss) {
        const int s0 = ss * kStrip;
        __syncthreads();  // sB, sX, sW free; sC staged
        for (int i = tid; i < kStrip * kN; i += kThreads) {
          const int r = i / kN, k = i % kN;
          const long long row = r0 + s0 + r;
          sB[r * kLd + k] = Bb[row * b_sr + k];
          sX[r * kP + k] = xb[row * x.sr + k] * sdt[s0 + r];
        }
        __syncthreads();
        // (t, s) tile of G, rows t = ty*4 + i, columns s = tx + 16 j
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
#pragma unroll 4
        for (int k = 0; k < kN; ++k) {
          float a[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sC[(ty * 4 + i) * kLd + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * kLd + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) w[i][j] += a[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            sW[(ty * 4 + i) * kLdW + tx + 16 * j] =
                s <= t ? w[i][j] * expf(sS[t] - sS[s]) : 0.f;
          }
        }
        __syncthreads();
        // y_intra += tile . (dt x), rows t = ty*4 + i, columns p = tx + 16 j
#pragma unroll 4
        for (int s = 0; s < kStrip; ++s) {
          float a[4], xv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sW[(ty * 4 + i) * kLdW + s];
#pragma unroll
          for (int j = 0; j < 8; ++j) xv[j] = sX[s * kP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * xv[j];
        }
      }

      // y_inter = C . h_in, then y = y_intra + y_inter e^{S[t]} (+ D x[t])
      float inter[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) inter[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < kN; ++k) {
        float a[4], hv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sC[(ty * 4 + i) * kLd + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) hv[j] = hc[k * kP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) inter[i][j] += a[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        const long long row = r0 + t;
        const float e = expf(sS[t]);
#pragma unroll
        for (int j = 0; j < 8; ++j) yb[row * d + tx + 16 * j] = acc[i][j] + inter[i][j] * e;
      }
      __syncthreads();  // the next strip overwrites sC
    }

    // ---- 2. the state: h <- e^{S_end} h + B^T (dt x e^{S_end - S}) --------
    const float send = sS[Q - 1];
    float st[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) st[i][j] = 0.f;
    for (int ss = 0; ss < n_strips; ++ss) {
      const int s0 = ss * kStrip;
      __syncthreads();
      for (int i = tid; i < kStrip * kN; i += kThreads) {
        const int r = i / kN, k = i % kN;
        const long long row = r0 + s0 + r;
        sB[r * kLd + k] = Bb[row * b_sr + k];
        sX[r * kP + k] = (xb[row * x.sr + k] * sdt[s0 + r]) * expf(send - sS[s0 + r]);
      }
      __syncthreads();
      // rows n = ty*8 + i, columns p = tx + 16 j
#pragma unroll 2
      for (int s = 0; s < kStrip; ++s) {
        float bv[8], xv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) bv[i] = sB[s * kLd + ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[j] = sX[s * kP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) st[i][j] += bv[i] * xv[j];
      }
    }
    const float decay = expf(send);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float& hv = hc[(ty * 8 + i) * kP + tx + 16 * j];
        hv = decay * hv + st[i][j];
      }
  }
  if (kHfin) {
    __syncthreads();
    float* hf = h_fin + bh * kN * kP;
    for (int i = tid; i < kN * kP; i += kThreads) hf[i] = hc[i];
  }
}

template <bool kStates, bool kHfin>
cudaError_t launch(Operand x, Operand Bm, Operand Cm, const float* dt, const float* S,
                   float* y, float* h_in, float* h_fin, int B, int L, int H, int Q,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * kSmemFloats;
  auto* kernel = ssd_fwd_kernel<kStates, kHfin>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, Bm, Cm, dt, S, y, h_in, h_fin, L, H, Q);
  return cudaGetLastError();
}

bool geometry_ok(int L, int N, int P, int Q) {
  return N == kN && P == kP && Q % kStrip == 0 && Q > 0 && Q <= kMaxChunk && L % Q == 0;
}

// ---------------------------------------------------------------------------
// K8: the chunk-parallel body (the note at the top of the file).

namespace chunked {

using ssd_tc::Acc;
using ssd_tc::AllActive;
using ssd_tc::for_each;
using ssd_tc::g_tile;
using ssd_tc::gemm;
using ssd_tc::kBK;
using ssd_tc::kBM;
using ssd_tc::kRingFloats;
using ssd_tc::kThreads;
using ssd_tc::pair_tiles;
using ssd_tc::Src;
using ssd_tc::zero;

constexpr int kNP = kN * kP;
constexpr int kCarryParts = kNP / (kThreads * 4);  // blocks a (b, h) in fwd_carry
constexpr int kSmemFloats = kRingFloats + 3 * kMaxChunk;

// The operands and outputs of one forward: x, B and C with their batch and
// row strides (x at head 0's first column), al_* when their rows are 16-byte
// aligned; dt, S (b, h, L); Dp (h); y (b, L, h p) contiguous; hin
// (b, nc - slot0, h, n, p), the slots slot0 .. nc - 1 of h_in: h_in itself
// (slot0 0) or the lean forward's scratch (slot0 1: the first chunk's state
// is 0 and read by nothing); G (b, nc, q, q) scratch; h_fin (b, h, n, p) for
// kHfin.
struct Args {
  Operand x, Bm, Cm;
  const float* dt;
  const float* S;
  const float* Dp;
  float* y;
  float* hin;
  float* G;
  float* h_fin;
  int B, L, H, Q, slot0;
  bool al_x, al_b, al_c;
};

__device__ __forceinline__ float* slot(const Args& a, int b, int c, int h) {
  const int held = a.L / a.Q - a.slot0;
  return a.hin + ((static_cast<long long>(b) * held + c - a.slot0) * a.H + h) * kNP;
}

// Blocks [0, B nc pairs): one G tile pair each. The rest: one (b, h, chunk,
// half of n) each, the chunk's local end state B^T (dt x e^{S_end - S}), for
// every chunk whose state is read (all but the last; all with kHfin), into
// h_in's slot c + 1 (h_fin for the last chunk).
template <bool kHfin>
__global__ void __launch_bounds__(kThreads, 2) fwd_prep(Args a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sF = smem + kRingFloats;
  const int nc = a.L / a.Q, T = a.Q / kBM, pairs = T * (T + 1) / 2;
  int bid = blockIdx.x;
  if (bid < a.B * nc * pairs) {
    const int pi = bid % pairs, c = bid / pairs % nc, b = bid / pairs / nc;
    int ti, si;
    pair_tiles(pi, ti, si);
    const long long r0 = static_cast<long long>(c) * a.Q;
    g_tile(ring, Src{a.Cm.p + b * a.Cm.sb + r0 * a.Cm.sr, a.Cm.sr, a.al_c},
           Src{a.Bm.p + b * a.Bm.sb + r0 * a.Bm.sr, a.Bm.sr, a.al_b}, ti, si,
           a.G + (static_cast<long long>(b) * nc + c) * a.Q * a.Q, a.Q);
    return;
  }
  bid -= a.B * nc * pairs;
  const int nstate = kHfin ? nc : nc - 1;
  const int half = bid & 1, h = (bid >> 1) % a.H, c = (bid >> 1) / a.H % nstate,
            b = (bid >> 1) / a.H / nstate;
  const long long bh = static_cast<long long>(b) * a.H + h, r0 = static_cast<long long>(c) * a.Q;
  const float* Sc = a.S + bh * a.L + r0;
  const float* dtc = a.dt + bh * a.L + r0;
  const float send = Sc[a.Q - 1];
  for (int i = threadIdx.x; i < a.Q; i += kThreads) sF[i] = dtc[i] * expf(send - Sc[i]);
  Acc<128> acc;
  zero<128>(acc);
  const float* Bc = a.Bm.p + b * a.Bm.sb + r0 * a.Bm.sr + half * kBM;
  const float* xc = a.x.p + b * a.x.sb + r0 * a.x.sr + h * kP;
  const long long bsr = a.Bm.sr, xsr = a.x.sr;
  const bool alb = a.al_b, alx = a.al_x;
  gemm<128, true, false, true>(
      acc, ring, a.Q / kBK, [=](int kt) { return Src{Bc + kt * kBK * bsr, bsr, alb}; },
      [=](int kt) { return Src{xc + kt * kBK * xsr, xsr, alx}; },
      [=](int kt, int, int k, float v) { return v * sF[kt * kBK + k]; }, AllActive{});
  float* dst = (c + 1 < nc ? slot(a, b, c + 1, h) : a.h_fin + bh * kNP) + half * kBM * kP;
  for_each<128>(acc, [=](int m, int n, float v) { dst[m * kP + n] = v; });
}

// h_in[c] = e^{S_end[c-1]} h_in[c-1] + (the local state in slot c) for
// c = 2 .. nc - 1 (slot 1 already holds h_in[1]); with kHfin then
// h_fin += e^{S_end[nc-1]} h_in[nc-1]. Grid (B h, kCarryParts), 4 elements a
// thread.
template <bool kHfin>
__global__ void __launch_bounds__(kThreads) fwd_carry(Args a) {
  const int nc = a.L / a.Q;
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / a.H), h = static_cast<int>(bh % a.H);
  const float* Sb = a.S + bh * a.L;
  const int e0 = blockIdx.y * kThreads * 4 + threadIdx.x;
  float prev[4];
  const float* first = slot(a, b, 1, h);
#pragma unroll
  for (int j = 0; j < 4; ++j) prev[j] = first[e0 + j * kThreads];
  for (int c = 2; c < nc; ++c) {
    const float decay = expf(Sb[static_cast<long long>(c) * a.Q - 1]);
    float* sc = slot(a, b, c, h);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = decay * prev[j] + sc[e0 + j * kThreads];
      sc[e0 + j * kThreads] = v;
      prev[j] = v;
    }
  }
  if (kHfin) {
    const float decay = expf(Sb[a.L - 1]);
    float* hf = a.h_fin + bh * kNP;
#pragma unroll
    for (int j = 0; j < 4; ++j) hf[e0 + j * kThreads] += decay * prev[j];
  }
}

// One (b, chunk, 64-row strip, head) a block, the longest strips first:
// y = (G (.) M) (dt x) + e^S C h_in [+ D x]. With kStates the first chunk's
// blocks also write h_in[0] = 0.
template <bool kStates, bool kD>
__global__ void __launch_bounds__(kThreads, 2) fwd_y(Args a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sS = smem + kRingFloats;
  float* sdt = sS + kMaxChunk;
  float* sE = sdt + kMaxChunk;
  const int nc = a.L / a.Q, T = a.Q / kBM;
  int bid = blockIdx.x;
  const int h = bid % a.H;
  bid /= a.H;
  const int ts = T - 1 - bid % T;
  bid /= T;
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
    const float* Ct = a.Cm.p + b * a.Cm.sb + (r0 + t0) * a.Cm.sr;
    const float* hc = slot(a, b, c, h);
    const long long csr = a.Cm.sr;
    const bool alc = a.al_c;
    gemm<128, false, false, true>(
        acc, ring, kN / kBK, [=](int kt) { return Src{Ct + kt * kBK, csr, alc}; },
        [=](int kt) { return Src{hc + kt * kBK * kP, kP, true}; },
        [=](int, int m, int, float v) { return v * sE[t0 + m]; }, AllActive{});
  }
  const long long Q = a.Q;
  const float* Gt = a.G + (static_cast<long long>(b) * nc + c) * Q * Q + t0 * Q;
  const float* xc = a.x.p + b * a.x.sb + r0 * a.x.sr + h * kP;
  const long long xsr = a.x.sr;
  const bool alx = a.al_x;
  gemm<128, false, false, true>(
      acc, ring, (t0 + kBM) / kBK, [=](int kt) { return Src{Gt + kt * kBK, Q, true}; },
      [=](int kt) { return Src{xc + kt * kBK * xsr, xsr, alx}; },
      [=](int kt, int m, int k, float v) {
        const int t = t0 + m, s = kt * kBK + k;
        return s <= t ? v * expf(sS[t] - sS[s]) * sdt[s] : 0.f;
      },
      [=](int kt, int wm) { return kt * kBK <= t0 + wm * 32 + 31; });
  const float skip = kD ? a.Dp[h] : 0.f;
  const long long d = static_cast<long long>(a.H) * kP;
  float* yt = a.y + (b * static_cast<long long>(a.L) + r0 + t0) * d + h * kP;
  const float* xt = xc + t0 * xsr;
  for_each<128>(acc, [=](int m, int n, float v) {
    yt[m * d + n] = kD ? v + skip * xt[m * xsr + n] : v;
  });
  if (kStates && c == 0) {
    float* z = slot(a, b, 0, h) + ts * (kNP / T);
    for (int i = threadIdx.x; i < kNP / T; i += kThreads) z[i] = 0.f;
  }
}

template <class K>
cudaError_t allow_smem(K* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(float)) * kSmemFloats);
}

template <bool kStates, bool kHfin, bool kD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * kSmemFloats;
  const int nc = a.L / a.Q, T = a.Q / kBM;
  cudaError_t err = allow_smem(fwd_prep<kHfin>);
  if (err == cudaSuccess) err = allow_smem(fwd_y<kStates, kD>);
  if (err != cudaSuccess) return err;
  const int n_prep = a.B * nc * T * (T + 1) / 2 + a.B * a.H * (kHfin ? nc : nc - 1) * 2;
  if (n_prep > 0) {
    fwd_prep<kHfin><<<n_prep, kThreads, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (nc > 2 || (kHfin && nc > 1)) {
    fwd_carry<kHfin><<<dim3(a.B * a.H, kCarryParts), kThreads, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  fwd_y<kStates, kD><<<a.B * nc * T * a.H, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The four variants K6 needs (with or without h_in and h_fin, no D term).
// They are instantiated so that every flag path is compiled, but no entry
// point launches them yet: they have never run, and K6's move onto this body
// is where they are first tested.
template cudaError_t launch<false, false, false>(const Args&, cudaStream_t);
template cudaError_t launch<true, false, false>(const Args&, cudaStream_t);
template cudaError_t launch<false, true, false>(const Args&, cudaStream_t);
template cudaError_t launch<true, true, false>(const Args&, cudaStream_t);

}  // namespace chunked

}  // namespace

extern "C" {

// K8. xbc: (B, L, d_inner + 2N) fp32 with strides (x_sb, x_sr, 1); dt, S:
// (B, H, L / Q, Q) contiguous; Dp: (H,); y: (B, L, d_inner) contiguous;
// hin: contiguous, 16-byte aligned, hin_n floats: h_in (B, L / Q, H, N, P)
// itself when states is 1, else a scratch (B, L / Q - 1, H, N, P) for the
// states entering chunks 1 .. L / Q - 1; G: a (B, L / Q, Q, Q)
// scratch of g_n floats, 16-byte aligned. Returns a cudaError_t code
// (cudaErrorInvalidValue for a geometry the kernels are not built for: N, P
// other than 128, Q not a multiple of 64 up to 256, L not a multiple of Q,
// d_inner other than H * P; or for a scratch size other than the geometry's).
int ssd_xbc_fwd(const void* xbc, const void* dt, const void* S, const void* Dp, void* y,
                void* hin, long long hin_n, int states, void* G, long long g_n, int B, int L,
                int H, int d_inner, int N, int P, int Q, long long x_sb, long long x_sr,
                void* stream) {
  if (!geometry_ok(L, N, P, Q) || d_inner != H * P) return cudaErrorInvalidValue;
  const long long nc = L / Q;
  const int slot0 = states ? 0 : 1;
  if (hin_n != B * (nc - slot0) * H * N * P || g_n != B * nc * Q * Q ||
      !ssd_tc::aligned16(hin, 0, 0) || !ssd_tc::aligned16(G, 0, 0))
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(xbc);
  const bool al = ssd_tc::aligned16(xf, x_sb, x_sr);
  const chunked::Args a{Operand{xf, x_sb, x_sr},
                        Operand{xf + d_inner, x_sb, x_sr},
                        Operand{xf + d_inner + N, x_sb, x_sr},
                        static_cast<const float*>(dt),
                        static_cast<const float*>(S),
                        static_cast<const float*>(Dp),
                        static_cast<float*>(y),
                        static_cast<float*>(hin),
                        static_cast<float*>(G),
                        nullptr,
                        B,
                        L,
                        H,
                        Q,
                        slot0,
                        al,
                        al,
                        al};
  auto s = static_cast<cudaStream_t>(stream);
  return states ? chunked::launch<true, false, true>(a, s)
                : chunked::launch<false, false, true>(a, s);
}

// K6. x: (B, L, H * P) with strides (x_sb, x_sr, 1); Bm, Cm: (B, L, N) with
// strides (b_sb, b_sr, 1) and (c_sb, c_sr, 1); dt, S: (B, H, L / Q, Q)
// contiguous; y: (B, L, H * P) contiguous; h_in: (B, L / Q, H, N, P)
// contiguous or null; h_fin: (B, H, N, P) contiguous or null. No D term.
// Returns a cudaError_t code, as ssd_xbc_fwd.
int ssd_split_fwd(const void* x, const void* Bm, const void* Cm, const void* dt,
                  const void* S, void* y, void* h_in, void* h_fin, int B, int L, int H,
                  int N, int P, int Q, long long x_sb, long long x_sr, long long b_sb,
                  long long b_sr, long long c_sb, long long c_sr, void* stream) {
  if (!geometry_ok(L, N, P, Q)) return cudaErrorInvalidValue;
  const Operand xo{static_cast<const float*>(x), x_sb, x_sr},
      bo{static_cast<const float*>(Bm), b_sb, b_sr},
      co{static_cast<const float*>(Cm), c_sb, c_sr};
  const auto* dtf = static_cast<const float*>(dt);
  const auto* sf = static_cast<const float*>(S);
  auto* yf = static_cast<float*>(y);
  auto* hi = static_cast<float*>(h_in);
  auto* hf = static_cast<float*>(h_fin);
  auto s = static_cast<cudaStream_t>(stream);
  if (hi != nullptr && hf != nullptr)
    return launch<true, true>(xo, bo, co, dtf, sf, yf, hi, hf, B, L, H, Q, s);
  if (hi != nullptr)
    return launch<true, false>(xo, bo, co, dtf, sf, yf, hi, nullptr, B, L, H, Q, s);
  if (hf != nullptr)
    return launch<false, true>(xo, bo, co, dtf, sf, yf, nullptr, hf, B, L, H, Q, s);
  return launch<false, false>(xo, bo, co, dtf, sf, yf, nullptr, nullptr, B, L, H, Q, s);
}

const char* ssd_xbc_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

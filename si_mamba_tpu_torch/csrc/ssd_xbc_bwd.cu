// Chunked SSD backward, fp32: K9, the backward of the boundary-fused K8, and
// K7, the backward of the split K6. For the forward of csrc/ssd_xbc_fwd.cu
// and the output gradient dy (b, l, d), per batch row b and head h, with
// GM = (C B^T) (.) M, M[t,s] = e^{S[t]-S[s]} (s <= t), E = e^S,
// T_end = e^{S_end - S} and dh the cotangent of the state leaving the chunk:
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
// dxbc. The dh of the last chunk is 0.
//
// Bound on the H100 at b=32, l=512, q=256, h=6, n=p=128: the function needs,
// per batch row, nc (3 q(q+1) n + 2h q(q+1) p) for the lower triangles of G,
// GM^T dy, dy (dt x)^T and of dG B, dG^T C taken once on dG summed over the
// heads, and (nc - 1) h 8qnp for dy h_in^T, the dh carry, B dh and
// (dt x T_end) dh^T (each is 0 or unread in the first or the last chunk):
// 14.5 GFLOP, against about 211 MB moved (xbc, dy, h_in in; dxbc, dS, ddt
// out; 63 us at 3.35 TB/s). At the fp32 rate (67 TFLOP/s) 0.217 ms; as 3xTF32
// on the tensor cores, three products for each against 495 TFLOP/s dense
// TF32, 0.088 ms.
//
// What held the earlier design back (grid (h, b), chunks walked in reverse in
// one block, 41.1 GFLOP executed on CUDA cores; kept below for K7 only), and
// what this one does about it:
//  1. Too few blocks (192 at B=32, one an SM for 228 KB). The forward saved
//     h_in, so only dh carries across chunks, and every (b, h, chunk) is
//     independent once it is known. Six launches: `bwd_prep` computes G of
//     every lower 64 x 64 tile pair of every (b, chunk) into a (b, nc, q, q)
//     scratch and every chunk's local carry term (C E)^T dy into the dh
//     scratch (b, nc, h, n, p); `bwd_carry` walks the chunks in reverse in one
//     launch, dh_out[c] = e^{S_end[c+1]} dh_out[c+1] + (C E)^T dy[c+1],
//     elementwise, with each chunk's sum(dh (.) h_in) as fixed-order partials;
//     `bwd_dgm` takes, per lower tile pair and every head in turn, dGM, the
//     head sum of dG (into a (b, nc, q, q) scratch) and the row and column
//     sums of dlogM; `bwd_dx`, per (b, chunk, 64-row strip, head), dxdt =
//     [B | GM^T] [dh ; dy] (B dh first, for dT), dx, ddt and dD; `bwd_dbc`,
//     per (b, chunk, 64-row strip) and dB or dC, the head sums
//     dC = dG B + sum_h E (dy h_in^T) (with each head's dE) and
//     dB = dG^T C + sum_h (dt x T_end) dh^T; `bwd_ds` finishes dS. At B=32:
//     1024, 3072 (16 a (b, h)), 640, 1536, 512 and 384 blocks.
//  2. 2.8x the products: G and dGM are computed once per tile (not twice), dB
//     and dC once on the head sum of dG (the per-head partials of 100.7 MB
//     and their torch.sum are gone), no product whose operand is 0 or whose
//     result is unread in the first or last chunk, and a warp skips a k-tile
//     whose masked rows are all 0.
//  3. fp32 FFMA: every product is 3xTF32 mma.sync (csrc/ssd_tc.cuh) behind a
//     three-stage cp.async ring.
// Every sum across heads, tiles or blocks runs in a fixed order, without
// atomics, so two runs are bitwise equal. dD stays a per-(b, h, chunk,
// strip) partial that the wrapper's torch.sum finishes.
//
// The body takes x, B, C and dy as separate operands with their own strides,
// and template flags for the D terms (kD) and a dh carry seeded with the
// cotangent of h_fin (kSeed: the last chunk's dh terms and dS_end term are
// then not 0), for K7's move onto it. Only K9's variant runs and is tested;
// K7's two (kD false, with and without kSeed) are instantiated at the end of
// the body, so the compiler checks them, but have never run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_runtime.h>

#include "ssd_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// K7: the earlier one-block-a-(batch, head) body, which serves the split
// backward (`ssd_split_bwd`) only, until K7's own change moves it onto the
// chunk-parallel body below and tests its variants there. It
// replaces `_make_bwd_kernel` behind `_bwd_call` (ssd_kernel.py:216, :388).
// The TPU kernel walks a reversed chunk grid axis with dh in VMEM scratch;
// here a loop inside the block walks the chunks in reverse, and the q x q
// products are taken in 64 x 64 tiles. kSeed starts the carry at the given
// dh_fin (sequence parallelism's carry; the last chunk's dS_end term
// e^{S_end} sum(dh (.) h_in) is then not 0). There are no D terms.
//
// Design: grid (h, b), 256 threads a block; each block owns one (b, h) and
// walks its chunks last first with dh (128 x 128, padded rows) in shared
// memory. For each chunk, in 64-row strips:
//  1. s-strips: the strip's B rows and dt x rows are staged; for every t-tile
//     at or after it, the tile's C and dy rows are staged, the 64 x 64 tiles
//     of G = C B^T and dGM = dy (dt x)^T computed, masked (s > t set to 0,
//     never exponentiated), and GM^T dy and dG^T C added to registers; the
//     tile's column sums of dlogM go to shared memory. Then B dh, dx, ddt and
//     dT, and (dt x T_end) dh^T, which completes this head's dB rows.
//  2. e^{S_end} sum(dh (.) h_in), while dh is still the chunk's dh_out.
//  3. t-strips: the strip's C and dy rows are staged; for every s-tile at or
//     before it, G and dGM again, dG B into registers and the row sums of
//     dlogM; then h_in is staged in the space of the B and dt x tiles,
//     dy h_in^T gives this head's dC rows and dE; then (C E)^T dy of the strip
//     is added to dh in place.
//  4. dS and ddt of the chunk are written.
// G and dGM are computed twice; dB and dC are per-head partials (b, h, l, 2n)
// that the wrapper's torch.sum over heads finishes; every reduction inside
// the block runs in a fixed order. K7 at the tensor-parallel shard (3 heads a
// rank at TP = 2) runs 96 blocks on the 132 SMs. CUDA cores only. Shared
// memory: 228,096 bytes.

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 64;
constexpr int kN = 128;
constexpr int kP = 128;
constexpr int kMaxChunk = 256;
constexpr int kLd = 129;
constexpr int kLdW = 65;
constexpr int kChunkArrays = 9;  // S, dt, E, T_end, rowsum, colsum, dE, dT, ddt

constexpr int kSmemFloats = kN * kLd                   // dh
                            + 2 * kStrip * kLd         // B, dt x tiles (h_in in step 3)
                            + 2 * kStrip * kLd         // C, dy tiles
                            + kStrip * kLdW            // (t, s) tile
                            + kChunkArrays * kMaxChunk
                            + 16 * kStrip;             // reduction scratch
static_assert(kN * kLd <= 2 * kStrip * kLd, "h_in must fit in the B and dt x tiles");

// acc[i][j] += sum_k a(i, k) b(j, k) over K steps.
template <int RI, int CJ, int K, class FA, class FB>
__device__ __forceinline__ void mma(float (&acc)[RI][CJ], FA a_at, FB b_at) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = a_at(i, k);
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = b_at(j, k);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] += a[i] * bv[j];
  }
}

template <int RI, int CJ>
__device__ __forceinline__ void zero(float (&acc)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
}

// Sum over the 16 threads of a row group (lanes tx = 0..15 of a half-warp).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block, the same value in every thread, in a fixed order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();  // every thread has read red
  return total;
}

// One strided operand: base pointer (at its first column) and the batch and
// row strides in floats.
struct Operand {
  const float* p;
  long long sb, sr;
};

template <bool kSeed>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(Operand x, Operand Bm, Operand Cm, Operand dy, const float* __restrict__ dt,
               const float* __restrict__ S, const float* __restrict__ h_in,
               const float* __restrict__ dh_fin, float* __restrict__ dx, long long dx_sb,
               long long dx_sr, float* __restrict__ dbc_part, float* __restrict__ ddt_out,
               float* __restrict__ dS_out, int L, int H, int Q) {
  extern __shared__ float smem[];
  float* dh = smem;                      // [kN][kLd]
  float* sB = dh + kN * kLd;             // [kStrip][kLd]
  float* sX = sB + kStrip * kLd;         // [kStrip][kLd]  dt x
  float* sH = sB;                        // [kN][kLd]  h_in, step 3 only
  float* sC = sX + kStrip * kLd;         // [kStrip][kLd]
  float* sDy = sC + kStrip * kLd;        // [kStrip][kLd]
  float* sT = sDy + kStrip * kLd;        // [kStrip][kLdW]
  float* sS = sT + kStrip * kLdW;        // [kMaxChunk] each
  float* sdt = sS + kMaxChunk;
  float* sE = sdt + kMaxChunk;
  float* sTe = sE + kMaxChunk;
  float* srow = sTe + kMaxChunk;
  float* scol = srow + kMaxChunk;
  float* sdE = scol + kMaxChunk;
  float* sdT = sdE + kMaxChunk;
  float* sddt = sdT + kMaxChunk;
  float* red = sddt + kMaxChunk;         // [16][kStrip]

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int nc = L / Q;
  const int n_strips = Q / kStrip;
  const float* xb = x.p + static_cast<long long>(b) * x.sb + head * kP;
  const float* Bb = Bm.p + static_cast<long long>(b) * Bm.sb;
  const float* Cb = Cm.p + static_cast<long long>(b) * Cm.sb;
  const float* dyb = dy.p + static_cast<long long>(b) * dy.sb + head * kP;
  const long long bh = static_cast<long long>(b) * H + head;
  const float* dtb = dt + bh * L;
  const float* Sb = S + bh * L;
  float* dxb = dx + static_cast<long long>(b) * dx_sb + head * kP;
  float* partb = dbc_part + bh * L * (2 * kN);

  if (kSeed) {
    const float* seed = dh_fin + bh * kN * kP;
    for (int i = tid; i < kN * kP; i += kThreads) dh[(i / kP) * kLd + i % kP] = seed[i];
  } else {
    for (int i = tid; i < kN * kLd; i += kThreads) dh[i] = 0.f;
  }

  for (int c = nc - 1; c >= 0; --c) {
    const int r0 = c * Q;
    const float* hin = h_in + ((static_cast<long long>(b) * nc + c) * H + head) * kN * kP;
    __syncthreads();  // the previous chunk is done with every array
    for (int i = tid; i < Q; i += kThreads) {
      const float s = Sb[r0 + i];
      sS[i] = s;
      sdt[i] = dtb[r0 + i];
      sE[i] = expf(s);
    }
    __syncthreads();
    const float send = sS[Q - 1];
    for (int i = tid; i < Q; i += kThreads) sTe[i] = expf(send - sS[i]);

    // ---- 1. s-strips: dx, ddt, dT, dB, column sums of dlogM ----------------
    for (int ss = 0; ss < n_strips; ++ss) {
      const int s0 = ss * kStrip;
      __syncthreads();
      for (int i = tid; i < kStrip * kN; i += kThreads) {
        const int r = i / kN, k = i % kN;
        const long long row = r0 + s0 + r;
        sB[r * kLd + k] = Bb[row * Bm.sr + k];
        sX[r * kLd + k] = xb[row * x.sr + k] * sdt[s0 + r];
      }
      float t1[4][8], dBa[4][8], cs[4] = {0.f, 0.f, 0.f, 0.f};
      zero(t1);
      zero(dBa);
      for (int ts = ss; ts < n_strips; ++ts) {
        const int t0 = ts * kStrip;
        __syncthreads();
        for (int i = tid; i < kStrip * kN; i += kThreads) {
          const int r = i / kN, k = i % kN;
          sC[r * kLd + k] = Cb[(r0 + t0 + r) * Cm.sr + k];
          sDy[r * kLd + k] = dyb[(r0 + t0 + r) * dy.sr + k];
        }
        __syncthreads();
        float g[4][4], dg[4][4];
        zero(g);
        zero(dg);
        mma<4, 4, kN>(g, [=](int i, int k) { return sC[(ty * 4 + i) * kLd + k]; },
                      [=](int j, int k) { return sB[(tx + 16 * j) * kLd + k]; });
        mma<4, 4, kP>(dg, [=](int i, int k) { return sDy[(ty * 4 + i) * kLd + k]; },
                      [=](int j, int k) { return sX[(tx + 16 * j) * kLd + k]; });
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float gm = 0.f, dgm = 0.f;
            if (s <= t) {
              const float m = expf(sS[t] - sS[s]);
              gm = g[i][j] * m;
              dgm = dg[i][j] * m;
              cs[j] += dg[i][j] * gm;
            }
            sT[(ty * 4 + i) * kLdW + tx + 16 * j] = gm;
            dg[i][j] = dgm;
          }
        }
        __syncthreads();
        // GM^T dy: rows s = ty*4 + i, columns p, over t
        mma<4, 8, kStrip>(t1, [=](int i, int k) { return sT[k * kLdW + ty * 4 + i]; },
                          [=](int j, int k) { return sDy[k * kLd + tx + 16 * j]; });
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sT[(ty * 4 + i) * kLdW + tx + 16 * j] = dg[i][j];
        __syncthreads();
        // dG^T C: rows s, columns n, over t
        mma<4, 8, kStrip>(dBa, [=](int i, int k) { return sT[k * kLdW + ty * 4 + i]; },
                          [=](int j, int k) { return sC[k * kLd + tx + 16 * j]; });
      }
      // column sums of dlogM over the 16 row groups, in order
#pragma unroll
      for (int j = 0; j < 4; ++j) red[ty * kStrip + tx + 16 * j] = cs[j];
      __syncthreads();
      if (tid < kStrip) {
        float v = 0.f;
        for (int r = 0; r < 16; ++r) v += red[r * kStrip + tid];
        scol[s0 + tid] = v;
      }
      // B dh: rows s, columns p, over n
      float bdh[4][8];
      zero(bdh);
      mma<4, 8, kN>(bdh, [=](int i, int k) { return sB[(ty * 4 + i) * kLd + k]; },
                    [=](int j, int k) { return dh[k * kLd + tx + 16 * j]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + ty * 4 + i;
        const long long row = r0 + s;
        const float dtv = sdt[s];
        const float te = sTe[s];
        float pddt = 0.f, pdT = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = tx + 16 * j;
          const float dxdt = t1[i][j] + bdh[i][j] * te;
          dxb[row * dx_sr + p] = dxdt * dtv;
          pddt += dxdt * xb[row * x.sr + p];
          pdT += bdh[i][j] * sX[(ty * 4 + i) * kLd + p];
        }
        pddt = row_sum16(pddt);
        pdT = row_sum16(pdT);
        if (tx == 0) {
          sddt[s] = pddt;
          sdT[s] = pdT;
        }
      }
      // (dt x T_end) dh^T: rows s, columns n, over p; completes dB
      mma<4, 8, kP>(dBa,
                    [=](int i, int k) { return sX[(ty * 4 + i) * kLd + k] * sTe[s0 + ty * 4 + i]; },
                    [=](int j, int k) { return dh[(tx + 16 * j) * kLd + k]; });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          partb[static_cast<long long>(r0 + s0 + ty * 4 + i) * (2 * kN) + tx + 16 * j] = dBa[i][j];
    }

    // ---- 2. e^{S_end} sum(dh_out (.) h_in) ---------------------------------
    float part = 0.f;
    for (int i = tid; i < kN * kP; i += kThreads) part += dh[(i / kP) * kLd + i % kP] * hin[i];
    const float hsum = block_sum(part, red);

    // ---- 3. t-strips: dC, dE, row sums of dlogM, the dh carry --------------
    for (int ts = 0; ts < n_strips; ++ts) {
      const int t0 = ts * kStrip;
      __syncthreads();
      for (int i = tid; i < kStrip * kN; i += kThreads) {
        const int r = i / kN, k = i % kN;
        sC[r * kLd + k] = Cb[(r0 + t0 + r) * Cm.sr + k];
        sDy[r * kLd + k] = dyb[(r0 + t0 + r) * dy.sr + k];
      }
      float dCa[4][8], rs[4] = {0.f, 0.f, 0.f, 0.f};
      zero(dCa);
      for (int ss = 0; ss <= ts; ++ss) {
        const int s0 = ss * kStrip;
        __syncthreads();
        for (int i = tid; i < kStrip * kN; i += kThreads) {
          const int r = i / kN, k = i % kN;
          const long long row = r0 + s0 + r;
          sB[r * kLd + k] = Bb[row * Bm.sr + k];
          sX[r * kLd + k] = xb[row * x.sr + k] * sdt[s0 + r];
        }
        __syncthreads();
        float g[4][4], dg[4][4];
        zero(g);
        zero(dg);
        mma<4, 4, kN>(g, [=](int i, int k) { return sC[(ty * 4 + i) * kLd + k]; },
                      [=](int j, int k) { return sB[(tx + 16 * j) * kLd + k]; });
        mma<4, 4, kP>(dg, [=](int i, int k) { return sDy[(ty * 4 + i) * kLd + k]; },
                      [=](int j, int k) { return sX[(tx + 16 * j) * kLd + k]; });
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            float dgm = 0.f;
            if (s <= t) {
              const float m = expf(sS[t] - sS[s]);
              dgm = dg[i][j] * m;
              rs[i] += dg[i][j] * (g[i][j] * m);
            }
            sT[(ty * 4 + i) * kLdW + tx + 16 * j] = dgm;
          }
        }
        __syncthreads();
        // dG B: rows t, columns n, over s
        mma<4, 8, kStrip>(dCa, [=](int i, int k) { return sT[(ty * 4 + i) * kLdW + k]; },
                          [=](int j, int k) { return sB[k * kLd + tx + 16 * j]; });
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = row_sum16(rs[i]);
        if (tx == 0) srow[t0 + ty * 4 + i] = v;
      }
      __syncthreads();  // the B and dt x tiles are free for h_in
      for (int i = tid; i < kN * kP; i += kThreads) sH[(i / kP) * kLd + i % kP] = hin[i];
      __syncthreads();
      // dy h_in^T: rows t, columns n, over p
      float yh[4][8];
      zero(yh);
      mma<4, 8, kP>(yh, [=](int i, int k) { return sDy[(ty * 4 + i) * kLd + k]; },
                    [=](int j, int k) { return sH[(tx + 16 * j) * kLd + k]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        const float e = sE[t];
        float pdE = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          partb[static_cast<long long>(r0 + t) * (2 * kN) + kN + n] = dCa[i][j] + yh[i][j] * e;
          pdE += sC[(ty * 4 + i) * kLd + n] * yh[i][j];
        }
        pdE = row_sum16(pdE);
        if (tx == 0) sdE[t] = pdE;
      }
      // dh <- (first strip ? e^{S_end} dh : dh) + (C E)^T dy over the strip:
      // rows n = ty*8 + i, columns p = tx + 16 j
      float acc[8][8];
      zero(acc);
      mma<8, 8, kStrip>(acc, [=](int i, int k) { return sC[k * kLd + ty * 8 + i] * sE[t0 + k]; },
                        [=](int j, int k) { return sDy[k * kLd + tx + 16 * j]; });
      const float decay = ts == 0 ? expf(send) : 1.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float& v = dh[(ty * 8 + i) * kLd + tx + 16 * j];
          v = decay * v + acc[i][j];
        }
    }

    // ---- 4. dS, ddt, dD of the chunk ---------------------------------------
    __syncthreads();  // srow, sdE, sdT, scol, sddt are complete
    float dsend = 0.f;
    for (int s = 0; s < Q; ++s) dsend += sdT[s] * sTe[s];  // every thread, same order
    dsend += expf(send) * hsum;
    for (int s = tid; s < Q; s += kThreads) {
      float v = srow[s] + sdE[s] * sE[s] - sdT[s] * sTe[s] - scol[s];
      if (s == Q - 1) v += dsend;
      dS_out[bh * L + r0 + s] = v;
      ddt_out[bh * L + r0 + s] = sddt[s];
    }
  }
}

template <bool kSeed>
cudaError_t launch(Operand x, Operand Bm, Operand Cm, Operand dy, const float* dt,
                   const float* S, const float* h_in, const float* dh_fin, float* dx,
                   long long dx_sb, long long dx_sr, float* dbc_part, float* ddt, float* dS,
                   int B, int L, int H, int Q, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * kSmemFloats;
  auto* kernel = ssd_bwd_kernel<kSeed>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, Bm, Cm, dy, dt, S, h_in, dh_fin, dx, dx_sb, dx_sr,
                                           dbc_part, ddt, dS, L, H, Q);
  return cudaGetLastError();
}

bool geometry_ok(int L, int N, int P, int Q) {
  return N == kN && P == kP && Q % kStrip == 0 && Q > 0 && Q <= kMaxChunk && L % Q == 0;
}

// ---------------------------------------------------------------------------
// K9: the chunk-parallel body (the note at the top of the file).

namespace chunked {

using ssd_tc::Acc;
using ssd_tc::AllActive;
using ssd_tc::block_sum;
using ssd_tc::col_sums;
using ssd_tc::for_each;
using ssd_tc::frag_pos;
using ssd_tc::g_tile;
using ssd_tc::gemm;
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

constexpr int kNP = kN * kP;
constexpr int kCarryParts = kNP / (kThreads * 4);  // blocks a (b, h) in bwd_carry
constexpr int kRed = 4 * kBM;                      // row_sums' and col_sums' scratch
constexpr int kSmemFloats = kRingFloats + 3 * kMaxChunk + kRed + kBM;

// An output with its batch and row strides (unit stride along channels).
struct Out {
  float* p;
  long long sb, sr;
};

// The operands, outputs and scratch of one backward. x, B, C and dy with
// their strides (x and dy at head 0's first column), al_* when their rows are
// 16-byte aligned; dt, S (b, h, L); Dp (h); hin (b, nc, h, n, p); dh_fin
// (b, h, n, p) for kSeed. Outputs dx, dB, dC; ddt, dS (b, h, L); dD_part
// (b, h, nc, q / 64). Scratch: G and dG (b, nc, q, q); dh (b, nc, h, n, p);
// rs, cs (b, h, nc, tile pairs, 64); dT, dE (b, h, L); hsum (b, h, nc,
// kCarryParts).
struct Args {
  Operand x, Bm, Cm, dy;
  const float* dt;
  const float* S;
  const float* Dp;
  const float* hin;
  const float* dh_fin;
  Out dx, dB, dC;
  float* ddt;
  float* dS;
  float* dD_part;
  float *G, *dG, *dh, *rs, *cs, *dT, *dE, *hsum;
  int B, L, H, Q;
  bool al_x, al_b, al_c, al_dy, al_hin;
};

__device__ __forceinline__ long long state_at(const Args& a, int b, int c, int h) {
  return ((static_cast<long long>(b) * (a.L / a.Q) + c) * a.H + h) * kNP;
}

// Blocks [0, B nc pairs): one G tile pair each. The rest: one (b, h, chunk
// c >= 1, half of n) each, the chunk's carry term (C E)^T dy into dh's slot
// c - 1 (bwd_carry adds the decayed carry from the chunks after it).
__global__ void __launch_bounds__(kThreads, 2) bwd_prep(Args a) {
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
  const int half = bid & 1, h = (bid >> 1) % a.H, c = 1 + (bid >> 1) / a.H % (nc - 1),
            b = (bid >> 1) / a.H / (nc - 1);
  const long long bh = static_cast<long long>(b) * a.H + h, r0 = static_cast<long long>(c) * a.Q;
  for (int i = threadIdx.x; i < a.Q; i += kThreads) sF[i] = expf(a.S[bh * a.L + r0 + i]);
  Acc<128> acc;
  zero<128>(acc);
  const float* Cc = a.Cm.p + b * a.Cm.sb + r0 * a.Cm.sr + half * kBM;
  const float* dyc = a.dy.p + b * a.dy.sb + r0 * a.dy.sr + h * kP;
  const long long csr = a.Cm.sr, dysr = a.dy.sr;
  const bool alc = a.al_c, aldy = a.al_dy;
  gemm<128, true, false, true>(
      acc, ring, a.Q / kBK, [=](int kt) { return Src{Cc + kt * kBK * csr, csr, alc}; },
      [=](int kt) { return Src{dyc + kt * kBK * dysr, dysr, aldy}; },
      [=](int kt, int, int k, float v) { return v * sF[kt * kBK + k]; }, AllActive{});
  float* dst = a.dh + state_at(a, b, c - 1, h) + half * kBM * kP;
  for_each<128>(acc, [=](int m, int n, float v) { dst[m * kP + n] = v; });
}

// dh_out[c] = e^{S_end[c+1]} dh_out[c+1] + (the carry term in slot c), from
// the last chunk whose dh is read (nc - 2, or nc - 1 = dh_fin with kSeed) down
// to 0, in place; each chunk's sum(dh_out (.) h_in) over this block's 1024
// elements goes to hsum. Grid (B h, kCarryParts), 4 elements a thread.
template <bool kSeed>
__global__ void __launch_bounds__(kThreads) bwd_carry(Args a) {
  __shared__ float red[kThreads / 32];
  const int nc = a.L / a.Q, top = kSeed ? nc - 1 : nc - 2;
  const long long bh = blockIdx.x;
  const int b = static_cast<int>(bh / a.H), h = static_cast<int>(bh % a.H);
  const float* Sb = a.S + bh * a.L;
  const int e0 = blockIdx.y * kThreads * 4 + threadIdx.x;
  float cur[4];
  for (int c = top; c >= 0; --c) {
    float* sc = a.dh + state_at(a, b, c, h);
    const float* hc = a.hin + state_at(a, b, c, h);
    const float decay = c == top ? 0.f : expf(Sb[static_cast<long long>(c + 2) * a.Q - 1]);
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + j * kThreads;
      float v;
      if (kSeed && c == nc - 1) {
        v = a.dh_fin[bh * kNP + e];
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
    if (threadIdx.x == 0) a.hsum[(bh * nc + c) * kCarryParts + blockIdx.y] = total;
  }
}

// One lower tile pair (ti, si) of one (b, chunk) a block; for each head in
// turn dGM = dy (dt x)^T over the tile, dG = dGM (.) M summed over the heads
// in registers (written to the dG scratch at the end, exact 0 above the
// diagonal), and the row and column sums of dlogM = dGM (.) G (.) M into
// rs / cs.
__global__ void __launch_bounds__(kThreads, 2) bwd_dgm(Args a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sSt = smem + kRingFloats;  // S of the tile's t rows, its s rows, dt of its s rows
  float* sSs = sSt + kBM;
  float* sdts = sSs + kBM;
  float* red = sSt + 3 * kMaxChunk;
  float* sums = red + kRed;
  const int nc = a.L / a.Q, T = a.Q / kBM, pairs = T * (T + 1) / 2;
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
    const float* dyt = a.dy.p + b * a.dy.sb + (r0 + t0) * dysr + h * kP;
    const float* xs = a.x.p + b * a.x.sb + (r0 + s0) * xsr + h * kP;
    gemm<64, false, true, false>(
        acc, ring, kP / kBK, [=](int kt) { return Src{dyt + kt * kBK, dysr, aldy}; },
        [=](int kt) { return Src{xs + kt * kBK, xsr, alx}; }, NoXform{}, AllActive{});
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < ssd_tc::Cfg<64>::kNT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          int m, n;
          frag_pos<64>(mi, ni, r, m, n);
          const float dgm = acc[mi][ni][r] * sdts[n];
          float dl = 0.f;
          if (s0 + n <= t0 + m) {
            const float mm = expf(sSt[m] - sSs[n]);
            dgs[mi][ni][r] += dgm * mm;
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
// T_end; not in a chunk whose dh is 0) plus GM^T dy, then dx, ddt and dD.
template <bool kD, bool kSeed>
__global__ void __launch_bounds__(kThreads, 2) bwd_dx(Args a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sS = smem + kRingFloats;
  float* sdt = sS + kMaxChunk;
  float* sTe = sdt + kMaxChunk;
  float* red = sTe + kMaxChunk;
  float* sums = red + kRed;
  const int nc = a.L / a.Q, T = a.Q / kBM;
  int bid = blockIdx.x;
  const int h = bid % a.H;
  bid /= a.H;
  const int ss = bid % T;
  bid /= T;
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
  const bool alx = a.al_x, aldy = a.al_dy, alb = a.al_b;
  const float* xs = a.x.p + b * a.x.sb + (r0 + s0) * xsr + h * kP;
  const float* dys = a.dy.p + b * a.dy.sb + (r0 + s0) * dysr + h * kP;
  Acc<128> acc;
  zero<128>(acc);
  const bool has_dh = kSeed || c < nc - 1;
  if (has_dh) {
    const float* Bs = a.Bm.p + b * a.Bm.sb + (r0 + s0) * bsr;
    const float* dhc = a.dh + state_at(a, b, c, h);
    gemm<128, false, false, false>(
        acc, ring, kN / kBK, [=](int kt) { return Src{Bs + kt * kBK, bsr, alb}; },
        [=](int kt) { return Src{dhc + kt * kBK * kP, kP, true}; }, NoXform{}, AllActive{});
    row_sums<128>(acc, [=](int m, int n, float v) { return v * xs[m * xsr + n] * sdt[s0 + m]; },
                  red, sums);
    for_each<128>(acc, [=](int m, int, float& v) { v *= sTe[s0 + m]; });
  }
  if (threadIdx.x < kBM) a.dT[bh * a.L + r0 + s0 + threadIdx.x] = has_dh ? sums[threadIdx.x] : 0.f;
  const float* Gs = a.G + (static_cast<long long>(b) * nc + c) * Q * Q + s0;
  gemm<128, true, false, true>(
      acc, ring, (a.Q - s0) / kBK, [=](int kt) { return Src{Gs + (s0 + kt * kBK) * Q, Q, true}; },
      [=](int kt) { return Src{dys + kt * kBK * dysr, dysr, aldy}; },
      [=](int kt, int m, int k, float v) {
        const int t = s0 + kt * kBK + k, s = s0 + m;
        return t >= s ? v * expf(sS[t] - sS[s]) : 0.f;
      },
      [=](int kt, int wm) { return kt * kBK + 31 >= wm * 32; });
  row_sums<128>(acc, [=](int m, int n, float v) { return v * xs[m * xsr + n]; }, red, sums);
  if (threadIdx.x < kBM) a.ddt[bh * a.L + r0 + s0 + threadIdx.x] = sums[threadIdx.x];
  const float skip = kD ? a.Dp[h] : 0.f;
  float* dxs = a.dx.p + b * a.dx.sb + (r0 + s0) * a.dx.sr + h * kP;
  const long long dxsr = a.dx.sr;
  float part = 0.f;
  for_each<128>(acc, [&](int m, int n, float v) {
    if (kD) {
      const float dyv = dys[m * dysr + n];
      dxs[m * dxsr + n] = v * sdt[s0 + m] + skip * dyv;
      part += dyv * xs[m * xsr + n];
    } else {
      dxs[m * dxsr + n] = v * sdt[s0 + m];
    }
  });
  if (kD) {
    const float total = block_sum(part, red);
    if (threadIdx.x == 0) a.dD_part[(bh * nc + c) * T + ss] = total;
  }
}

// One (b, chunk, 64-row strip) and one of dC (even blocks) or dB (odd) a block:
//   dC = dG B + sum_h E (dy h_in^T), writing each head's dE on the way;
//   dB = dG^T C + sum_h (dt x T_end) dh^T;
// the heads in order, the per-head products skipped where h_in or dh is 0.
template <bool kSeed>
__global__ void __launch_bounds__(kThreads, 2) bwd_dbc(Args a) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* sF = smem + kRingFloats;
  float* red = sF + 3 * kMaxChunk;
  float* sums = red + kRed;
  const int nc = a.L / a.Q, T = a.Q / kBM;
  const int is_db = blockIdx.x & 1, strip = (blockIdx.x >> 1) % T,
            c = (blockIdx.x >> 1) / T % nc, b = (blockIdx.x >> 1) / T / nc;
  const long long Q = a.Q, r0 = static_cast<long long>(c) * a.Q;
  const int r = strip * kBM;  // the strip's first row: t0 for dC, s0 for dB
  const float* dGc = a.dG + (static_cast<long long>(b) * nc + c) * Q * Q;
  const long long xsr = a.x.sr, dysr = a.dy.sr, bsr = a.Bm.sr, csr = a.Cm.sr;
  const bool alx = a.al_x, aldy = a.al_dy, alb = a.al_b, alc = a.al_c, alhin = a.al_hin;
  Acc<128> acc;
  zero<128>(acc);
  if (!is_db) {
    const float* Ct = a.Cm.p + b * a.Cm.sb + (r0 + r) * csr;
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
      const float* dyt = a.dy.p + b * a.dy.sb + (r0 + r) * dysr + h * kP;
      const float* hc = a.hin + state_at(a, b, c, h);
      gemm<128, false, true, false>(
          yh, ring, kP / kBK, [=](int kt) { return Src{dyt + kt * kBK, dysr, aldy}; },
          [=](int kt) { return Src{hc + kt * kBK, kP, alhin}; }, NoXform{}, AllActive{});
      row_sums<128>(yh, [=](int m, int n, float v) { return v * Ct[m * csr + n]; }, red, sums);
      if (threadIdx.x < kBM) dEt[threadIdx.x] = sums[threadIdx.x];
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
    const float* Bc = a.Bm.p + b * a.Bm.sb + r0 * bsr;
    const float* dGt = dGc + r * Q;
    gemm<128, false, false, false>(
        acc, ring, (r + kBM) / kBK, [=](int kt) { return Src{dGt + kt * kBK, Q, true}; },
        [=](int kt) { return Src{Bc + kt * kBK * bsr, bsr, alb}; }, NoXform{},
        [=](int kt, int wm) { return kt * kBK <= r + wm * 32 + 31; });
    float* out = a.dC.p + b * a.dC.sb + (r0 + r) * a.dC.sr;
    const long long osr = a.dC.sr;
    for_each<128>(acc, [=](int m, int n, float v) { out[m * osr + n] = v; });
    return;
  }
  if (kSeed || c < nc - 1) {  // the last chunk's dh is 0
    for (int h = 0; h < a.H; ++h) {
      const long long bh = static_cast<long long>(b) * a.H + h;
      __syncthreads();  // the previous head is done with sF
      if (threadIdx.x < kBM) {
        const float* Sc = a.S + bh * a.L + r0;
        sF[threadIdx.x] = a.dt[bh * a.L + r0 + r + threadIdx.x] *
                          expf(Sc[a.Q - 1] - Sc[r + threadIdx.x]);
      }
      const float* xs = a.x.p + b * a.x.sb + (r0 + r) * xsr + h * kP;
      const float* dhc = a.dh + state_at(a, b, c, h);
      gemm<128, false, true, true>(
          acc, ring, kP / kBK, [=](int kt) { return Src{xs + kt * kBK, xsr, alx}; },
          [=](int kt) { return Src{dhc + kt * kBK, kP, true}; },
          [=](int, int m, int, float v) { return v * sF[m]; }, AllActive{});
    }
  }
  const float* Cc = a.Cm.p + b * a.Cm.sb + r0 * csr;
  const float* dGs = dGc + r;
  gemm<128, true, false, false>(
      acc, ring, (a.Q - r) / kBK, [=](int kt) { return Src{dGs + (r + kt * kBK) * Q, Q, true}; },
      [=](int kt) { return Src{Cc + (r + kt * kBK) * csr, csr, alc}; }, NoXform{},
      [=](int kt, int wm) { return kt * kBK + 31 >= wm * 32; });
  float* out = a.dB.p + b * a.dB.sb + (r0 + r) * a.dB.sr;
  const long long osr = a.dB.sr;
  for_each<128>(acc, [=](int m, int n, float v) { out[m * osr + n] = v; });
}

// One (b, h, chunk) a block, a thread a row: dS = rowsum(dlogM) + dE E -
// dT T_end - colsum(dlogM), and at the chunk's last row dSend = sum(dT T_end)
// + e^{S_end} sum(dh (.) h_in), every sum in a fixed order.
template <bool kSeed>
__global__ void __launch_bounds__(kThreads) bwd_ds(Args a) {
  __shared__ float red[kThreads / 32];
  const int nc = a.L / a.Q, T = a.Q / kBM, pairs = T * (T + 1) / 2;
  const int c = blockIdx.x % nc;
  const long long bh = blockIdx.x / nc, r0 = static_cast<long long>(c) * a.Q;
  const int i = threadIdx.x;
  const long long at = bh * a.L + r0;
  const float send = a.S[at + a.Q - 1];
  float v = 0.f, dtte = 0.f;
  if (i < a.Q) {
    const long long base = (bh * nc + c) * pairs;
    float rowsum = 0.f, colsum = 0.f;
    const int tile = i / kBM, row = i % kBM;
    for (int si = 0; si <= tile; ++si) rowsum += a.rs[(base + pair_index(tile, si)) * kBM + row];
    for (int ti = tile; ti < T; ++ti) colsum += a.cs[(base + pair_index(ti, tile)) * kBM + row];
    const float s = a.S[at + i];
    dtte = a.dT[at + i] * expf(send - s);
    v = rowsum + a.dE[at + i] * expf(s) - dtte - colsum;
  }
  const float total = block_sum(dtte, red);
  float hs = 0.f;
  if (c <= (kSeed ? nc - 1 : nc - 2))
    for (int j = 0; j < kCarryParts; ++j) hs += a.hsum[(bh * nc + c) * kCarryParts + j];
  if (i < a.Q) a.dS[at + i] = i == a.Q - 1 ? v + (total + expf(send) * hs) : v;
}

template <class K>
cudaError_t allow_smem(K* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(float)) * kSmemFloats);
}

// The floats of the scratch that one backward needs, in the order Args
// lists it.
long long scratch_floats(int B, int L, int H, int Q) {
  const long long nc = L / Q, T = Q / kBM, pairs = T * (T + 1) / 2;
  return 2 * B * nc * Q * Q + B * nc * H * kNP + 2 * B * H * nc * pairs * kBM +
         2 * static_cast<long long>(B) * H * L + B * H * nc * kCarryParts;
}

template <bool kD, bool kSeed>
cudaError_t launch(Args a, float* scratch, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * kSmemFloats;
  const int nc = a.L / a.Q, T = a.Q / kBM, pairs = T * (T + 1) / 2;
  const long long qq = static_cast<long long>(a.B) * nc * a.Q * a.Q;
  const long long rows = static_cast<long long>(a.B) * a.H * a.L;
  const long long tiles = static_cast<long long>(a.B) * a.H * nc * pairs * kBM;
  a.G = scratch;
  a.dG = a.G + qq;
  a.dh = a.dG + qq;
  a.rs = a.dh + static_cast<long long>(a.B) * nc * a.H * kNP;
  a.cs = a.rs + tiles;
  a.dT = a.cs + tiles;
  a.dE = a.dT + rows;
  a.hsum = a.dE + rows;
  cudaError_t err = allow_smem(bwd_prep);
  if (err == cudaSuccess) err = allow_smem(bwd_dgm);
  if (err == cudaSuccess) err = allow_smem(bwd_dx<kD, kSeed>);
  if (err == cudaSuccess) err = allow_smem(bwd_dbc<kSeed>);
  if (err != cudaSuccess) return err;
  bwd_prep<<<a.B * nc * pairs + a.B * a.H * (nc - 1) * 2, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (kSeed || nc > 1) {
    bwd_carry<kSeed><<<dim3(a.B * a.H, kCarryParts), kThreads, 0, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  bwd_dgm<<<a.B * nc * pairs, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dx<kD, kSeed><<<a.B * nc * T * a.H, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dbc<kSeed><<<a.B * nc * T * 2, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_ds<kSeed><<<a.B * a.H * nc, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The two variants K7 needs (the dh carry from 0 or seeded, no D terms).
// They are instantiated so that every flag path is compiled, but no entry
// point launches them yet: they have never run, and K7's move onto this body
// is where they are first tested.
template cudaError_t launch<false, false>(Args, float*, cudaStream_t);
template cudaError_t launch<false, true>(Args, float*, cudaStream_t);

}  // namespace chunked

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
// (B, H, L / Q, 16) partials of sum(dh (.) h_in), in that order. Returns a cudaError_t code
// (cudaErrorInvalidValue for a geometry the kernels are not built for, or
// for a dD_part or scratch size other than the geometry's).
int ssd_xbc_bwd(const void* xbc, const void* dt, const void* S, const void* Dp,
                const void* h_in, const void* dy, void* dxbc, void* ddt, void* dS,
                void* dD_part, long long dD_n, void* scratch, long long scratch_n, int B, int L,
                int H, int d_inner, int N, int P, int Q, long long x_sb, long long x_sr,
                long long dy_sb, long long dy_sr, void* stream) {
  if (!geometry_ok(L, N, P, Q) || d_inner != H * P) return cudaErrorInvalidValue;
  const long long nc = L / Q;
  if (dD_n != B * H * nc * (Q / ssd_tc::kBM) ||
      scratch_n != chunked::scratch_floats(B, L, H, Q) || !ssd_tc::aligned16(scratch, 0, 0))
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(xbc);
  auto* dxf = static_cast<float*>(dxbc);
  const long long total = d_inner + 2 * N;
  const bool al = ssd_tc::aligned16(xf, x_sb, x_sr);
  chunked::Args a{};
  a.x = Operand{xf, x_sb, x_sr};
  a.Bm = Operand{xf + d_inner, x_sb, x_sr};
  a.Cm = Operand{xf + d_inner + N, x_sb, x_sr};
  a.dy = Operand{static_cast<const float*>(dy), dy_sb, dy_sr};
  a.dt = static_cast<const float*>(dt);
  a.S = static_cast<const float*>(S);
  a.Dp = static_cast<const float*>(Dp);
  a.hin = static_cast<const float*>(h_in);
  a.dx = chunked::Out{dxf, L * total, total};
  a.dB = chunked::Out{dxf + d_inner, L * total, total};
  a.dC = chunked::Out{dxf + d_inner + N, L * total, total};
  a.ddt = static_cast<float*>(ddt);
  a.dS = static_cast<float*>(dS);
  a.dD_part = static_cast<float*>(dD_part);
  a.B = B;
  a.L = L;
  a.H = H;
  a.Q = Q;
  a.al_x = a.al_b = a.al_c = al;
  a.al_dy = ssd_tc::aligned16(dy, dy_sb, dy_sr);
  a.al_hin = ssd_tc::aligned16(h_in, 0, 0);
  return chunked::launch<true, false>(a, static_cast<float*>(scratch),
                                      static_cast<cudaStream_t>(stream));
}

// K7. Inputs: x (B, L, H * P), Bm, Cm (B, L, N) and dy (B, L, H * P), each with
// its strides (_sb, _sr, 1); dt, S (B, H, L / Q, Q) contiguous; h_in
// (B, L / Q, H, N, P) contiguous; dh_fin (B, H, N, P) contiguous, or null for
// the unseeded variant. Outputs, contiguous: dx (B, L, H * P); dbc_part
// (B, H, L, 2N), this head's dB | dC; ddt, dS (B, H, L / Q, Q). No D terms.
// Returns a cudaError_t code, as ssd_xbc_bwd.
int ssd_split_bwd(const void* x, const void* Bm, const void* Cm, const void* dt,
                  const void* S, const void* h_in, const void* dy, const void* dh_fin,
                  void* dx, void* dbc_part, void* ddt, void* dS, int B, int L, int H,
                  int N, int P, int Q, long long x_sb, long long x_sr, long long b_sb,
                  long long b_sr, long long c_sb, long long c_sr, long long dy_sb,
                  long long dy_sr, void* stream) {
  if (!geometry_ok(L, N, P, Q)) return cudaErrorInvalidValue;
  const Operand xo{static_cast<const float*>(x), x_sb, x_sr},
      bo{static_cast<const float*>(Bm), b_sb, b_sr},
      co{static_cast<const float*>(Cm), c_sb, c_sr},
      dyo{static_cast<const float*>(dy), dy_sb, dy_sr};
  const long long d = static_cast<long long>(H) * P;
  const auto* dtf = static_cast<const float*>(dt);
  const auto* sf = static_cast<const float*>(S);
  const auto* hi = static_cast<const float*>(h_in);
  const auto* seed = static_cast<const float*>(dh_fin);
  auto* dxf = static_cast<float*>(dx);
  auto* part = static_cast<float*>(dbc_part);
  auto* ddtf = static_cast<float*>(ddt);
  auto* dsf = static_cast<float*>(dS);
  auto s = static_cast<cudaStream_t>(stream);
  if (seed != nullptr)
    return launch<true>(xo, bo, co, dyo, dtf, sf, hi, seed, dxf, L * d, d, part, ddtf, dsf, B, L,
                        H, Q, s);
  return launch<false>(xo, bo, co, dyo, dtf, sf, hi, nullptr, dxf, L * d, d, part, ddtf, dsf, B,
                       L, H, Q, s);
}

const char* ssd_xbc_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

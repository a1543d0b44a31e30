// Chunked SSD backward, fp32: the boundary-fused K9 and the split K7 from one
// kernel body. For the forward of csrc/ssd_xbc_fwd.cu (K8, K6) and the output
// gradient dy (b, l, d), per batch row b and head h, with GM = (C B^T) (.) M,
// M[t,s] = e^{S[t]-S[s]} (s <= t), E = e^S, T_end = e^{S_end - S} and dh the
// cotangent of the state leaving the chunk:
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
// The dh of the last chunk is 0, or with kSeed the given dh_fin, the
// cotangent of the forward's h_fin (sequence parallelism's carry); seeded,
// the last chunk's dS_end term e^{S_end} sum(dh (.) h_in) is not 0. kDSkip
// adds the D terms. x, B, C and dy come with their own batch and row strides,
// dx with its own.
//
// K9 (`ssd_xbc_bwd`, kDSkip, unseeded) replaces the TPU kernel
// `_make_bwd_kernel_xbc` behind `_bwd_call_xbc`: x, B and C are the column
// groups of xbc, and dx the x columns of dxbc. K7 (`ssd_split_bwd`, no D
// terms, seeded or not) replaces `_make_bwd_kernel` behind `_bwd_call` (both
// with the per-head maths `_bwd_head`, si_mamba_tpu/ops/pallas/ssd_kernel.py).
// The TPU kernels walk a reversed chunk grid axis with dh in VMEM scratch and
// hold q x q products whole; here a loop inside the block walks the chunks in
// reverse, and the q x q products are taken in 64 x 64 tiles.
//
// Bound on the H100: fp32 operations. At b=32, l=512, q=256, h=6, n=p=128 the
// function needs, per batch row, nc (3 q(q+1) n + 2h q(q+1) p) for the lower
// triangles of G, GM^T dy, dy (dt x)^T and of dG B, dG^T C taken once on dG
// summed over the heads, and (nc - 1) h 8qnp for dy h_in^T, the dh carry,
// B dh and (dt x T_end) dh^T (each is 0 or unread in the first or the last
// chunk): 14.5 GFLOP in all, 0.217 ms at 67 TFLOP/s, against about 210 MB
// moved (xbc, dy, h_in in; dxbc, dS, ddt out), 63 us at 3.35 TB/s. This
// design executes 41.1 GFLOP: G and dGM twice, dB and dC per head, whole
// diagonal tiles, and all four (q, n, p) products in every chunk.
//
// Design: grid (h, b), 256 threads a block; each block owns one (b, h) and
// walks its chunks last first with dh (128 x 128, padded rows) in shared
// memory. For each chunk, in 64-row strips:
//  1. s-strips: the strip's B rows and dt x rows are staged; for every t-tile
//     at or after it, the tile's C and dy rows are staged, the 64 x 64 tiles
//     of G = C B^T and dGM = dy (dt x)^T computed, masked (s > t set to 0,
//     never exponentiated), and GM^T dy and dG^T C added to registers; the
//     tile's column sums of dlogM go to shared memory. Then B dh, dx (written
//     to the x columns of dxbc), ddt and dT, and (dt x T_end) dh^T, which
//     completes this head's dB rows.
//  2. e^{S_end} sum(dh (.) h_in), while dh is still the chunk's dh_out.
//  3. t-strips: the strip's C and dy rows are staged; for every s-tile at or
//     before it, G and dGM again, dG B into registers and the row sums of
//     dlogM; then h_in is staged in the space of the B and dt x tiles,
//     dy h_in^T gives this head's dC rows and dE; then (C E)^T dy of the strip
//     is added to dh in place (each thread owns 64 entries).
//  4. dS and ddt of the chunk are written, and (kDSkip) the chunk's dD
//     partial.
// G and dGM are computed twice (in steps 1 and 3) rather than stored: a
// chunk's q x q tiles do not fit beside dh. dB and dC are per-head partials
// (b, h, l, 2n) that the wrapper's torch.sum over heads finishes, dD a
// per-(b, h, chunk) partial; every reduction inside the block runs in a fixed
// order (shuffles over the 16 threads of a row, then shared memory), so the
// sums are deterministic without atomics. K7 at the tensor-parallel shard
// (3 heads a rank at TP = 2) runs 96 blocks on the 132 SMs. Thread layout,
// padding and the absence of tensor cores and fast math are as in K8. Shared
// memory: 228,096 bytes (dynamic, opted in past 48 KB).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_runtime.h>

namespace {

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

template <bool kDSkip, bool kSeed>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(Operand x, Operand Bm, Operand Cm, Operand dy, const float* __restrict__ dt,
               const float* __restrict__ S, const float* __restrict__ Dp,
               const float* __restrict__ h_in, const float* __restrict__ dh_fin,
               float* __restrict__ dx, long long dx_sb, long long dx_sr,
               float* __restrict__ dbc_part, float* __restrict__ ddt_out,
               float* __restrict__ dS_out, float* __restrict__ dD_part, int L, int H,
               int Q) {
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
  const float skip = kDSkip ? Dp[head] : 0.f;
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
    float dD_acc = 0.f;

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
          const float xv = xb[row * x.sr + p];
          if (kDSkip) {
            const float dyv = dyb[row * dy.sr + p];
            dxb[row * dx_sr + p] = dxdt * dtv + skip * dyv;
            dD_acc += dyv * xv;
          } else {
            dxb[row * dx_sr + p] = dxdt * dtv;
          }
          pddt += dxdt * xv;
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
    if (kDSkip) {
      const float dD = block_sum(dD_acc, red);
      if (tid == 0) dD_part[bh * nc + c] = dD;
    }
  }
}

template <bool kDSkip, bool kSeed>
cudaError_t launch(Operand x, Operand Bm, Operand Cm, Operand dy, const float* dt,
                   const float* S, const float* Dp, const float* h_in, const float* dh_fin,
                   float* dx, long long dx_sb, long long dx_sr, float* dbc_part, float* ddt,
                   float* dS, float* dD_part, int B, int L, int H, int Q,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * kSmemFloats;
  auto* kernel = ssd_bwd_kernel<kDSkip, kSeed>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, Bm, Cm, dy, dt, S, Dp, h_in, dh_fin, dx, dx_sb,
                                           dx_sr, dbc_part, ddt, dS, dD_part, L, H, Q);
  return cudaGetLastError();
}

bool geometry_ok(int L, int N, int P, int Q) {
  return N == kN && P == kP && Q % kStrip == 0 && Q > 0 && Q <= kMaxChunk && L % Q == 0;
}

}  // namespace

extern "C" {

// K9. Inputs: xbc (B, L, d_inner + 2N) with strides (x_sb, x_sr, 1); dt, S
// (B, H, L / Q, Q) contiguous; Dp (H,); h_in (B, L / Q, H, N, P) contiguous;
// dy (B, L, d_inner) with strides (dy_sb, dy_sr, 1).
// Outputs, contiguous: dxbc (B, L, d_inner + 2N), of which the kernel writes
// the x columns; dbc_part (B, H, L, 2N), this head's dB | dC; ddt, dS
// (B, H, L / Q, Q); dD_part (B, H, L / Q). Returns a cudaError_t code
// (cudaErrorInvalidValue for a geometry the kernel is not built for).
int ssd_xbc_bwd(const void* xbc, const void* dt, const void* S, const void* Dp,
                const void* h_in, const void* dy, void* dxbc, void* dbc_part,
                void* ddt, void* dS, void* dD_part, int B, int L, int H,
                int d_inner, int N, int P, int Q, long long x_sb, long long x_sr,
                long long dy_sb, long long dy_sr, void* stream) {
  if (!geometry_ok(L, N, P, Q) || d_inner != H * P) return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(xbc);
  const long long total = d_inner + 2 * N;
  return launch<true, false>(
      Operand{xf, x_sb, x_sr}, Operand{xf + d_inner, x_sb, x_sr},
      Operand{xf + d_inner + N, x_sb, x_sr},
      Operand{static_cast<const float*>(dy), dy_sb, dy_sr}, static_cast<const float*>(dt),
      static_cast<const float*>(S), static_cast<const float*>(Dp),
      static_cast<const float*>(h_in), nullptr, static_cast<float*>(dxbc), L * total, total,
      static_cast<float*>(dbc_part), static_cast<float*>(ddt), static_cast<float*>(dS),
      static_cast<float*>(dD_part), B, L, H, Q, static_cast<cudaStream_t>(stream));
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
    return launch<false, true>(xo, bo, co, dyo, dtf, sf, nullptr, hi, seed, dxf, L * d, d, part,
                               ddtf, dsf, nullptr, B, L, H, Q, s);
  return launch<false, false>(xo, bo, co, dyo, dtf, sf, nullptr, hi, nullptr, dxf, L * d, d,
                              part, ddtf, dsf, nullptr, B, L, H, Q, s);
}

const char* ssd_xbc_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Chunked SSD forward, fp32: the boundary-fused K8 and the split K6 from one
// kernel body. Per batch row b and head h, with the chunk's inclusive
// log-decay cumsum S (non-increasing) and the state h_in entering the chunk:
//
//   y[t]  = sum_{s<=t} (C[t].B[s]) e^{S[t]-S[s]} dt[s] x[s]
//           + e^{S[t]} C[t] . h_in [+ D x[t]]
//   h_out = e^{S_end} h_in + sum_s B[s] (x) (dt[s] x[s] e^{S_end-S[s]})
//
// x (b, l, h p), B and C (b, l, n) each come with their own batch and row
// strides (unit stride along channels); y is (b, l, h p) contiguous.
// Template flags: kStates also writes h_in (b, nc, h, n, p) for the backward;
// kHfin writes the state after the last chunk, h_fin (b, h, n, p), the carry
// of sequence parallelism; kXbc (K8) adds the D x term and takes B and C as
// columns of x's buffer, with x's strides, so one row offset serves all three.
//
// K8 (`ssd_xbc_fwd`, kXbc) replaces the TPU kernel `_make_fwd_kernel_xbc`
// behind `_fwd_call_xbc`: x, B and C are the column groups [x | B | C] of the
// mixer's un-split conv output xbc (b, l, d + 2n). K6 (`ssd_split_fwd`, no D
// term) replaces `_make_fwd_kernel` behind `_fwd_call` (both in
// si_mamba_tpu/ops/pallas/ssd_kernel.py), whose operands arrive split, as the
// tensor- and sequence-parallel mixers make them. The TPU kernels' grid is
// (b, nc) with the chunk axis sequential and the (h, n, p) state in VMEM
// scratch; they hold the head-shared q x q G = C B^T whole. Here a loop
// inside the block takes the place of the sequential chunk axis, and G cannot
// be held whole: at q = 256 it is 256 KB, more than a block's 227 KB of
// shared memory.
//
// Bound on the H100: fp32 operations. At b=32, l=512, q=256, h=6, n=p=128 the
// function needs, per batch row, nc (q(q+1) n + h q(q+1) p) for the lower
// triangles of G and of (G (.) M)(dt x), and (nc - 1) h 4qnp for C h_in (h_in
// of the first chunk is 0) and the carry (the last chunk's state is not
// read): 7.0 GFLOP in all, 0.104 ms at 67 TFLOP/s, against 67 MB of xbc in,
// 50 MB of y and (in training) 25 MB of h_in out, 43 us at 3.35 TB/s. This
// design executes 14.5 GFLOP: G per head, whole diagonal tiles, and both
// (q, n, p) products in every chunk.
//
// K6 at the tensor-parallel shard (h = 3 heads a rank at TP = 2) runs the
// same work per head; its grid of 3 x 32 = 96 blocks leaves 36 of the 132 SMs
// idle.
//
// Design: grid (h, b), 256 threads a block; each block owns one (b, h) and
// walks its chunks in order with the 128 x 128 state in shared memory. For
// each chunk:
//  1. y, one strip of 64 time rows at a time: the strip's C rows are staged
//     in shared memory; for each 64-row tile of earlier-or-equal rows s, the
//     tile's B rows and dt x rows are staged, the 64 x 64 tile of
//     G (.) e^{S[t]-S[s]} is computed (tiles with s > t are skipped, and in
//     the diagonal tile entries with s > t are set to 0, never exponentiated;
//     every exponent used is <= 0), and its product with dt x is added to
//     registers. Then C h_in e^{S[t]} (and D x[t]) are added and y is written.
//     G is recomputed per head, which adds about 38 % to the operations
//     (6 heads x 2q^2 n against one), so no 256 KB G is held; the strips keep
//     every operand of a product in shared memory.
//  2. the state: B^T (dt x e^{S_end-S}) over 64-row tiles into 64 registers
//     a thread, then h <- e^{S_end} h + that, in place (each thread owns its
//     64 entries of the state). After the last chunk kHfin copies it out.
// Each thread owns a 4 x 8 (strip) or 8 x 8 (state) block of the output with
// the columns 16 apart, so a warp's reads of a staged row are contiguous;
// rows that 16 threads read along their length are padded to 129 floats, so
// those reads fall in distinct banks. No tensor cores (the TF32 of wgmma
// would round the fp32 operands to 10 mantissa bits), no atomics, no fast
// math. Shared memory: 182,784 bytes (dynamic, opted in past 48 KB).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_runtime.h>

namespace {

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

template <bool kStates, bool kHfin, bool kXbc>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_kernel(Operand x, Operand Bm, Operand Cm, const float* __restrict__ dt,
               const float* __restrict__ S, const float* __restrict__ Dp,
               float* __restrict__ y, float* __restrict__ h_in,
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
  const float skip = kXbc ? Dp[head] : 0.f;
  const float* xb = x.p + static_cast<long long>(b) * x.sb + head * kP;
  const long long b_sr = kXbc ? x.sr : Bm.sr, c_sr = kXbc ? x.sr : Cm.sr;
  const float* Bb = Bm.p + static_cast<long long>(b) * (kXbc ? x.sb : Bm.sb);
  const float* Cb = Cm.p + static_cast<long long>(b) * (kXbc ? x.sb : Cm.sb);
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
        for (int j = 0; j < 8; ++j) {
          const int p = tx + 16 * j;
          float v = acc[i][j] + inter[i][j] * e;
          if (kXbc) v += skip * xb[row * x.sr + p];
          yb[row * d + p] = v;
        }
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

template <bool kStates, bool kHfin, bool kXbc>
cudaError_t launch(Operand x, Operand Bm, Operand Cm, const float* dt, const float* S,
                   const float* Dp, float* y, float* h_in, float* h_fin, int B,
                   int L, int H, int Q, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * kSmemFloats;
  auto* kernel = ssd_fwd_kernel<kStates, kHfin, kXbc>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, Bm, Cm, dt, S, Dp, y, h_in, h_fin, L, H, Q);
  return cudaGetLastError();
}

bool geometry_ok(int L, int N, int P, int Q) {
  return N == kN && P == kP && Q % kStrip == 0 && Q > 0 && Q <= kMaxChunk && L % Q == 0;
}

}  // namespace

extern "C" {

// K8. xbc: (B, L, d_inner + 2N) fp32 with strides (x_sb, x_sr, 1); dt, S:
// (B, H, L / Q, Q) contiguous; Dp: (H,); y: (B, L, d_inner) contiguous;
// h_in: (B, L / Q, H, N, P) contiguous, or null for the lean variant.
// Returns a cudaError_t code (cudaErrorInvalidValue for a geometry the kernel
// is not built for: N, P other than 128, Q not a multiple of 64 up to 256, L
// not a multiple of Q, d_inner other than H * P).
int ssd_xbc_fwd(const void* xbc, const void* dt, const void* S, const void* Dp,
                void* y, void* h_in, int B, int L, int H, int d_inner, int N,
                int P, int Q, long long x_sb, long long x_sr, void* stream) {
  if (!geometry_ok(L, N, P, Q) || d_inner != H * P) return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(xbc);
  const Operand x{xf, x_sb, x_sr}, Bm{xf + d_inner, x_sb, x_sr},
      Cm{xf + d_inner + N, x_sb, x_sr};
  const auto* dtf = static_cast<const float*>(dt);
  const auto* sf = static_cast<const float*>(S);
  const auto* df = static_cast<const float*>(Dp);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (h_in != nullptr)
    return launch<true, false, true>(x, Bm, Cm, dtf, sf, df, yf, static_cast<float*>(h_in),
                                     nullptr, B, L, H, Q, s);
  return launch<false, false, true>(x, Bm, Cm, dtf, sf, df, yf, nullptr, nullptr, B, L, H,
                                    Q, s);
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
    return launch<true, true, false>(xo, bo, co, dtf, sf, nullptr, yf, hi, hf, B, L, H, Q, s);
  if (hi != nullptr)
    return launch<true, false, false>(xo, bo, co, dtf, sf, nullptr, yf, hi, nullptr, B, L, H,
                                      Q, s);
  if (hf != nullptr)
    return launch<false, true, false>(xo, bo, co, dtf, sf, nullptr, yf, nullptr, hf, B, L, H,
                                      Q, s);
  return launch<false, false, false>(xo, bo, co, dtf, sf, nullptr, yf, nullptr, nullptr, B, L,
                                     H, Q, s);
}

const char* ssd_xbc_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

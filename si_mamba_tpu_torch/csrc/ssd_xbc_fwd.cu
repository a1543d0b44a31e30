// Boundary-fused chunked SSD forward (K8), fp32. Per batch row b and head h,
// with the chunk's inclusive log-decay cumsum S (non-increasing) and the
// state h_in entering the chunk:
//
//   y[t]  = sum_{s<=t} (C[t].B[s]) e^{S[t]-S[s]} dt[s] x[s]
//           + e^{S[t]} C[t] . h_in + D x[t]
//   h_out = e^{S_end} h_in + sum_s B[s] (x) (dt[s] x[s] e^{S_end-S[s]})
//
// x, B and C are the column groups [x | B | C] of the mixer's un-split conv
// output xbc (b, l, d + 2n); y is (b, l, d). One variant (kStates) also writes
// h_in (b, nc, h, n, p) for the backward, the other (serving) does not.
//
// Replaces the TPU kernel `_make_fwd_kernel_xbc` behind `_fwd_call_xbc`
// (si_mamba_tpu/ops/pallas/ssd_kernel.py). The TPU kernel's grid is (b, nc)
// with the chunk axis sequential and the (h, n, p) state in VMEM scratch; it
// holds the head-shared q x q G = C B^T whole. Here a loop inside the block
// takes the place of the sequential chunk axis, and G cannot be held whole:
// at q = 256 it is 256 KB, more than a block's 227 KB of shared memory.
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
// Design: grid (h, b), 256 threads a block; each block owns one (b, h) and
// walks its chunks in order with the 128 x 128 state in shared memory. For
// each chunk:
//  1. y, one strip of 64 time rows at a time: the strip's C rows are staged
//     in shared memory; for each 64-row tile of earlier-or-equal rows s, the
//     tile's B rows and dt x rows are staged, the 64 x 64 tile of
//     G (.) e^{S[t]-S[s]} is computed (tiles with s > t are skipped, and in
//     the diagonal tile entries with s > t are set to 0, never exponentiated;
//     every exponent used is <= 0), and its product with dt x is added to
//     registers. Then C h_in e^{S[t]} and D x[t] are added and y is written.
//     G is recomputed per head, which adds about 38 % to the operations
//     (6 heads x 2q^2 n against one), so no 256 KB G is held; the strips keep
//     every operand of a product in shared memory.
//  2. the state: B^T (dt x e^{S_end-S}) over 64-row tiles into 64 registers
//     a thread, then h <- e^{S_end} h + that, in place (each thread owns its
//     64 entries of the state).
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

template <bool kStates>
__global__ void __launch_bounds__(kThreads, 1)
ssd_xbc_fwd_kernel(const float* __restrict__ xbc, const float* __restrict__ dt,
                   const float* __restrict__ S, const float* __restrict__ Dp,
                   float* __restrict__ y, float* __restrict__ h_in, int L,
                   int H, int d_inner, int Q, long long x_sb, long long x_sr) {
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
  const float skip = Dp[head];
  const float* xb = xbc + static_cast<long long>(b) * x_sb;
  const int xcol = head * kP;
  const int bcol = d_inner;
  const int ccol = d_inner + kN;
  const long long bh = static_cast<long long>(b) * H + head;
  const float* dtb = dt + bh * L;  // (b, h, nc, q) is (b, h, L)
  const float* Sb = S + bh * L;
  float* yb = y + static_cast<long long>(b) * L * d_inner + xcol;

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
        sC[r * kLd + k] = xb[(r0 + t0 + r) * x_sr + ccol + k];
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
          const long long row = (r0 + s0 + r) * x_sr;
          sB[r * kLd + k] = xb[row + bcol + k];
          sX[r * kP + k] = xb[row + xcol + k] * sdt[s0 + r];
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

      // y_inter = C . h_in, then y = y_intra + y_inter e^{S[t]} + D x[t]
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
          const float xv = xb[row * x_sr + xcol + p];
          yb[row * d_inner + p] = acc[i][j] + inter[i][j] * e + skip * xv;
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
        const long long row = (r0 + s0 + r) * x_sr;
        sB[r * kLd + k] = xb[row + bcol + k];
        sX[r * kP + k] = (xb[row + xcol + k] * sdt[s0 + r]) * expf(send - sS[s0 + r]);
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
}

template <bool kStates>
cudaError_t launch(const float* xbc, const float* dt, const float* S,
                   const float* Dp, float* y, float* h_in, int B, int L, int H,
                   int d_inner, int Q, long long x_sb, long long x_sr,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * kSmemFloats;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_xbc_fwd_kernel<kStates>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  ssd_xbc_fwd_kernel<kStates><<<grid, kThreads, smem, stream>>>(
      xbc, dt, S, Dp, y, h_in, L, H, d_inner, Q, x_sb, x_sr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xbc: (B, L, d_inner + 2N) fp32 with strides (x_sb, x_sr, 1); dt, S:
// (B, H, L / Q, Q) contiguous; Dp: (H,); y: (B, L, d_inner) contiguous;
// h_in: (B, L / Q, H, N, P) contiguous, or null for the lean variant.
// Returns a cudaError_t code (cudaErrorInvalidValue for a geometry the kernel
// is not built for: N, P other than 128, Q not a multiple of 64 up to 256, L
// not a multiple of Q, d_inner other than H * P).
int ssd_xbc_fwd(const void* xbc, const void* dt, const void* S, const void* Dp,
                void* y, void* h_in, int B, int L, int H, int d_inner, int N,
                int P, int Q, long long x_sb, long long x_sr, void* stream) {
  if (N != kN || P != kP || Q % kStrip != 0 || Q <= 0 || Q > kMaxChunk ||
      L % Q != 0 || d_inner != H * P)
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(xbc);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* sf = static_cast<const float*>(S);
  const auto* df = static_cast<const float*>(Dp);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (h_in != nullptr)
    return launch<true>(xf, dtf, sf, df, yf, static_cast<float*>(h_in), B, L, H,
                        d_inner, Q, x_sb, x_sr, s);
  return launch<false>(xf, dtf, sf, df, yf, nullptr, B, L, H, d_inner, Q, x_sb,
                       x_sr, s);
}

const char* ssd_xbc_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

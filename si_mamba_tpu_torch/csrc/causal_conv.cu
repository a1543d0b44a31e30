// Depthwise causal width-W convolution + bias + SiLU, forward, fp32.
//
// Replaces the TPU kernel `_fwd_kernel` behind `causal_conv1d_silu_pallas`
// (si_mamba_tpu/ops/pallas/causal_conv_kernel.py), which holds a whole
// (L, block_d) slab in VMEM and builds the time shifts by concatenation.
//
// Bound on the H100: bytes. Every output reads W inputs that its neighbours
// in time also read, so the least traffic is one read of x and one write of
// y (2 x 50.3 MB per layer at B=32, L=512, D=768, about 30 us at 3.35 TB/s);
// the 2W+5 operations per output are two orders of magnitude below the fp32
// rate.
//
// Design: one thread per channel d, 128 channels per block, so that each
// warp's loads and stores of one time row are 128 contiguous bytes. A block
// walks a tile of kTimeTile steps; each thread keeps the W-1 previous inputs
// of its channel in registers, so every input is read from device memory
// once (plus W-1 halo rows per tile). x may be a column slice of a wider
// buffer (the mixer's xz): the kernel takes x's batch and row strides and
// needs unit stride only along channels. No padding of L or D: the ragged
// edges are masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no fast math: expf keeps parity with the
//        reference implementations).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTimeTile = 64;

template <int W>
__global__ void __launch_bounds__(kThreads)
causal_conv1d_silu_fwd_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ bias,
                              float* __restrict__ y, int L, int D,
                              long long x_sb, long long x_sr) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const int b = blockIdx.y;
  const int t0 = blockIdx.z * kTimeTile;
  const int t_end = min(t0 + kTimeTile, L);

  const float* xb = x + static_cast<long long>(b) * x_sb + d;
  float* yb = y + static_cast<long long>(b) * L * D + d;

  float wk[W];
#pragma unroll
  for (int k = 0; k < W; ++k) wk[k] = w[d * W + k];
  const float bd = bias[d];

  // win[k] holds x[t - (W-1) + k]; win[W-1] is loaded each step.
  float win[W];
#pragma unroll
  for (int k = 0; k < W - 1; ++k) {
    const int t = t0 - (W - 1) + k;
    win[k] = t >= 0 ? xb[static_cast<long long>(t) * x_sr] : 0.f;
  }

#pragma unroll 4
  for (int t = t0; t < t_end; ++t) {
    win[W - 1] = xb[static_cast<long long>(t) * x_sr];
    // same summation order as the TPU kernel: bias, then taps oldest first
    float s = bd;
#pragma unroll
    for (int k = 0; k < W; ++k) s += wk[k] * win[k];
    yb[static_cast<long long>(t) * D] = s / (1.f + expf(-s));
#pragma unroll
    for (int k = 0; k < W - 1; ++k) win[k] = win[k + 1];
  }
}

// Backward of the same function (replaces the TPU kernel `_bwd_kernel` behind
// `_cc_bwd`, si_mamba_tpu/ops/pallas/causal_conv_kernel.py). With
// s = b + sum_k w[k] x[t-W+1+k] and y = silu(s):
//
//   ds[t]  = g[t] * sig(s[t]) * (1 + s[t] * (1 - sig(s[t])))
//   dx[t]  = sum_k w[k] ds[t+W-1-k]
//   dw[k] += ds[t] x[t-W+1+k],   db += ds[t]
//
// Bound on the H100: bytes. One read of x and g and one write of dx (3 x
// 50.3 MB per layer at B=32, L=512, D=768, about 45 us at 3.35 TB/s); the
// weight-gradient partials are B * ceil(L/64) * (W+1) * D floats, 1 % of
// that.
//
// Design: the forward's grid and thread layout (one thread per channel, 128
// channels a block, a tile of kTimeTile steps per block), so rows stay
// coalesced and there are B * ceil(L/64) * ceil(D/128) blocks (1536 at the
// shape above). Each thread recomputes s from a window of the W-1 previous
// inputs and keeps the last W values of ds in registers: dx[t] needs ds up to
// t+W-1, so the loop runs W-1 steps past the tile (its look-ahead halo) and
// emits dx[t] W-1 steps late. dw and db are summed in registers over the
// tile's own steps and written as per-(batch, tile) partials; the wrapper's
// torch.sum finishes them. No atomics, so the sums are deterministic.
template <int W>
__global__ void __launch_bounds__(kThreads)
causal_conv1d_silu_bwd_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ bias,
                              const float* __restrict__ g,
                              float* __restrict__ dx,
                              float* __restrict__ dw_part,
                              float* __restrict__ db_part, int L, int D,
                              long long x_sb, long long x_sr,
                              long long g_sb, long long g_sr) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const int b = blockIdx.y;
  const int tile = blockIdx.z;
  const int t0 = tile * kTimeTile;
  const int t_end = min(t0 + kTimeTile, L);
  const int t_last = min(t_end + W - 1, L);  // ds is needed up to t_end+W-2

  const float* xb = x + static_cast<long long>(b) * x_sb + d;
  const float* gb = g + static_cast<long long>(b) * g_sb + d;
  float* dxb = dx + static_cast<long long>(b) * L * D + d;

  float wk[W];
#pragma unroll
  for (int k = 0; k < W; ++k) wk[k] = w[d * W + k];
  const float bd = bias[d];

  float win[W];  // win[k] = x[t - (W-1) + k]
#pragma unroll
  for (int k = 0; k < W - 1; ++k) {
    const int t = t0 - (W - 1) + k;
    win[k] = t >= 0 ? xb[static_cast<long long>(t) * x_sr] : 0.f;
  }
  float dsw[W];  // dsw[j] = ds[t - (W-1) + j]; zeros before the tile start
#pragma unroll
  for (int j = 0; j < W; ++j) dsw[j] = 0.f;
  float dwk[W];
#pragma unroll
  for (int k = 0; k < W; ++k) dwk[k] = 0.f;
  float dbv = 0.f;

  for (int t = t0; t < t_end + W - 1; ++t) {
    float ds = 0.f;  // ds[t] = 0 past the end of the sequence
    if (t < t_last) {
      win[W - 1] = xb[static_cast<long long>(t) * x_sr];
      float s = bd;
#pragma unroll
      for (int k = 0; k < W; ++k) s += wk[k] * win[k];
      const float sig = 1.f / (1.f + expf(-s));
      ds = gb[static_cast<long long>(t) * g_sr] * sig * (1.f + s * (1.f - sig));
      if (t < t_end) {
#pragma unroll
        for (int k = 0; k < W; ++k) dwk[k] += ds * win[k];
        dbv += ds;
      }
#pragma unroll
      for (int k = 0; k < W - 1; ++k) win[k] = win[k + 1];
    }
#pragma unroll
    for (int j = 0; j < W - 1; ++j) dsw[j] = dsw[j + 1];
    dsw[W - 1] = ds;
    const int te = t - (W - 1);  // dx[te] = sum_k w[k] ds[te + W-1-k]
    if (te >= t0) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) acc += wk[k] * dsw[W - 1 - k];
      dxb[static_cast<long long>(te) * D] = acc;
    }
  }
  const long long part = static_cast<long long>(b) * gridDim.z + tile;
#pragma unroll
  for (int k = 0; k < W; ++k) dw_part[(part * W + k) * D + d] = dwk[k];
  db_part[part * D + d] = dbv;
}

template <int W>
cudaError_t launch(const float* x, const float* w, const float* bias, float* y,
                   int B, int L, int D, long long x_sb, long long x_sr,
                   cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B,
                  (L + kTimeTile - 1) / kTimeTile);
  causal_conv1d_silu_fwd_kernel<W>
      <<<grid, kThreads, 0, stream>>>(x, w, bias, y, L, D, x_sb, x_sr);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_bwd(const float* x, const float* w, const float* bias,
                       const float* g, float* dx, float* dw_part,
                       float* db_part, int B, int L, int D, long long x_sb,
                       long long x_sr, long long g_sb, long long g_sr,
                       cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B,
                  (L + kTimeTile - 1) / kTimeTile);
  causal_conv1d_silu_bwd_kernel<W><<<grid, kThreads, 0, stream>>>(
      x, w, bias, g, dx, dw_part, db_part, L, D, x_sb, x_sr, g_sb, g_sr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, L, D) fp32 with strides (x_sb, x_sr, 1); w: (D, W) contiguous;
// bias: (D,); y: (B, L, D) contiguous. Returns a cudaError_t code
// (cudaErrorInvalidValue for a W other than 4).
int causal_conv1d_silu_fwd(const void* x, const void* w, const void* bias,
                           void* y, int B, int L, int D, int W, long long x_sb,
                           long long x_sr, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  // width 4 (d_conv) is the only one a ported model uses
  if (W != 4) return cudaErrorInvalidValue;
  return launch<4>(xf, wf, bf, yf, B, L, D, x_sb, x_sr, s);
}

// Backward. x, g: (B, L, D) fp32 with strides (x_sb, x_sr, 1) and
// (g_sb, g_sr, 1); w: (D, W); bias: (D,); dx: (B, L, D) contiguous;
// dw_part: (B, ceil(L/64), W, D) and db_part: (B, ceil(L/64), D), the
// per-(batch, time tile) partial sums, contiguous. Returns a cudaError_t code.
int causal_conv1d_silu_bwd(const void* x, const void* w, const void* bias,
                           const void* g, void* dx, void* dw_part,
                           void* db_part, int B, int L, int D, int W,
                           long long x_sb, long long x_sr, long long g_sb,
                           long long g_sr, void* stream) {
  if (W != 4) return cudaErrorInvalidValue;
  return launch_bwd<4>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(g),
      static_cast<float*>(dx), static_cast<float*>(dw_part),
      static_cast<float*>(db_part), B, L, D, x_sb, x_sr, g_sb, g_sr,
      static_cast<cudaStream_t>(stream));
}

int causal_conv1d_time_tile() { return kTimeTile; }

const char* causal_conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

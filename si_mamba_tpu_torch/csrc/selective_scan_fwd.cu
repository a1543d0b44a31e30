// Mamba-1 selective scan, inference forward, fp32:
//
//   delta_t = softplus(dt_t + dt_bias)
//   h_t     = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) * B_t   (fp32 state)
//   y_t     = (C_t . h_t + D * u_t) * silu(z_t)
//
// Replaces the lean variant of the TPU kernel `_fwd_kernel`
// (`_pallas_scan_fwd(..., emit_residuals=False)`, reached from
// `selective_scan_pallas` in si_mamba_tpu/ops/pallas/selective_scan_kernel.py).
// The TPU kernel scans (n, T, block_d) chunks with Hillis-Steele passes and
// pads L to a multiple of 128; none of that layout carries over.
//
// Bound on the H100: bytes first. The least traffic is one read of u, dt, z
// (3 x 50.3 MB at B=32, L=512, d=768), of B and C (2 x 1 MB), and one write
// of y (50.3 MB): about 203 MB, 61 us at 3.35 TB/s. The work is B*L*d*n
// exponentials (201 M at that shape) plus about 7 fp32 operations per state
// element, which keeps the fp32 and special-function units busy close to
// that time, so the kernel is near the ridge.
//
// Design: grid (B, ceil(d / 128)); one thread per channel with the whole
// n-vector of its state and of A in registers (n is a template parameter),
// and a sequential loop over time, so the (B, L, d, n) discretised tensors
// never exist. Per tile of kChunk steps the block stages B_t and C_t (shared
// by all its channels) in shared memory, and each thread issues the loads of
// its u, dt and z for the whole tile before it computes, to keep many loads
// in flight. The inputs may be column slices of wider buffers (z of xz,
// B and C of x_dbl): each takes its own batch and row stride. No padding of
// L or d: the ragged edges are masked. softplus is
// `v > 20 ? v : log1pf(expf(v))` and silu is z / (1 + expf(-z)), with the
// accurate expf/log1pf (no fast math).
//
// This grid has B * d / 128 blocks: 192 at B=32, 12 at B=2, so small serve
// batches leave most of the 132 SMs idle; a split-L two-pass scan is the
// known remedy.
//
// Training variant (template flag kResiduals, entry point
// `selective_scan_fwd_residuals`): replaces the same TPU kernel with
// `emit_residuals=True` (reached through `_vjp_fwd`). It also writes the fp32
// state at the entry of every kChunk-step tile, h_entries (B, ceil(L/kChunk),
// N, D), the anchors from which the backward (selective_scan_bwd.cu) rebuilds
// each tile's states. That adds L/kChunk * N floats per channel: 50.3 MB at
// B=32, L=512, d=768 (kChunk = 16, chosen for the backward's shared memory),
// coalesced across the block's channels. The TPU kernel also saves the
// pre-gate output y_pre so that its backward skips the C-contraction; here
// the backward has each state in hand when it needs y_pre and recomputes it
// with N fused multiply-adds, which saves a 50.3 MB write and a 50.3 MB read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

template <int N, bool kResiduals>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ Dp,
                          const float* __restrict__ z,
                          const float* __restrict__ dt_bias,
                          float* __restrict__ y,
                          float* __restrict__ h_entries, int L, int D,
                          long long u_sb, long long u_sr,
                          long long dt_sb, long long dt_sr,
                          long long B_sb, long long B_sr,
                          long long C_sb, long long C_sr,
                          long long z_sb, long long z_sr) {
  __shared__ float sB[kChunk][N];
  __shared__ float sC[kChunk][N];

  const int b = blockIdx.x;
  const int d = blockIdx.y * kThreads + threadIdx.x;
  const bool active = d < D;
  const int dd = active ? d : 0;  // keeps masked-off threads' addresses valid

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[dd * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float skip = active ? Dp[dd] : 0.f;
  const float bias = active ? dt_bias[dd] : 0.f;

  const float* ub = u + b * u_sb + dd;
  const float* dtb = dt + b * dt_sb + dd;
  const float* zb = z + b * z_sb + dd;
  const float* Bb = Bm + b * B_sb;
  const float* Cb = Cm + b * C_sb;
  float* yb = y + static_cast<long long>(b) * L * D + dd;

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    if (kResiduals && active) {
      const long long tile =
          static_cast<long long>(b) * ((L + kChunk - 1) / kChunk) + t0 / kChunk;
      float* he = h_entries + tile * N * D + dd;
#pragma unroll
      for (int n = 0; n < N; ++n) he[static_cast<long long>(n) * D] = h[n];
    }
    for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
      const int r = i / N, n = i % N, t = t0 + r;
      sB[r][n] = t < L ? Bb[t * B_sr + n] : 0.f;
      sC[r][n] = t < L ? Cb[t * C_sr + n] : 0.f;
    }
    float uu[kChunk], dv[kChunk], zz[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const long long t = t0 + r;
      const bool ok = active && t < L;
      uu[r] = ok ? ub[t * u_sr] : 0.f;
      dv[r] = ok ? dtb[t * dt_sr] : 0.f;
      zz[r] = ok ? zb[t * z_sr] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      if (t0 + r < L) {
        const float v = dv[r] + bias;
        const float delta = v > 20.f ? v : log1pf(expf(v));
        const float du = delta * uu[r];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(delta * a[n]) * h[n] + du * sB[r][n];
          acc += sC[r][n] * h[n];
        }
        const float out = acc + skip * uu[r];
        const float gate = zz[r] / (1.f + expf(-zz[r]));
        if (active) yb[static_cast<long long>(t0 + r) * D] = out * gate;
      }
    }
    __syncthreads();
  }
}

template <int N, bool kResiduals>
cudaError_t launch(const float* u, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* Dp,
                   const float* z, const float* dt_bias, float* y,
                   float* h_entries, int Bsz, int L, int D, const long long* s,
                   cudaStream_t stream) {
  const dim3 grid(Bsz, (D + kThreads - 1) / kThreads);
  selective_scan_fwd_kernel<N, kResiduals><<<grid, kThreads, 0, stream>>>(
      u, dt, A, Bm, Cm, Dp, z, dt_bias, y, h_entries, L, D, s[0], s[1], s[2],
      s[3], s[4], s[5], s[6], s[7], s[8], s[9]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u, dt, z: (B, L, D); Bm, Cm: (B, L, N); each with unit stride along its
// last axis and the (batch, row) strides given in `strides` in the order
// u, dt, B, C, z (10 values). A: (D, N) contiguous; Dp, dt_bias: (D,);
// y: (B, L, D) contiguous. Returns a cudaError_t code (cudaErrorInvalidValue
// for an N other than 16).
int selective_scan_fwd(const void* u, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* Dp,
                       const void* z, const void* dt_bias, void* y, int Bsz,
                       int L, int D, int N, const long long* strides,
                       void* stream) {
  const auto* uf = static_cast<const float*>(u);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bf = static_cast<const float*>(Bm);
  const auto* Cf = static_cast<const float*>(Cm);
  const auto* Df = static_cast<const float*>(Dp);
  const auto* zf = static_cast<const float*>(z);
  const auto* bf = static_cast<const float*>(dt_bias);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  // d_state 16 is the only one a ported model uses
  if (N != 16) return cudaErrorInvalidValue;
  return launch<16, false>(uf, dtf, Af, Bf, Cf, Df, zf, bf, yf, nullptr, Bsz, L,
                           D, strides, s);
}

// Training variant: as selective_scan_fwd, and also writes h_entries
// (Bsz, ceil(L / kChunk), N, D) fp32 contiguous, the state before each tile.
int selective_scan_fwd_residuals(const void* u, const void* dt, const void* A,
                                 const void* Bm, const void* Cm,
                                 const void* Dp, const void* z,
                                 const void* dt_bias, void* y, void* h_entries,
                                 int Bsz, int L, int D, int N,
                                 const long long* strides, void* stream) {
  if (N != 16) return cudaErrorInvalidValue;
  return launch<16, true>(
      static_cast<const float*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(Dp),
      static_cast<const float*>(z), static_cast<const float*>(dt_bias),
      static_cast<float*>(y), static_cast<float*>(h_entries), Bsz, L, D,
      strides, static_cast<cudaStream_t>(stream));
}

int selective_scan_chunk_len() { return kChunk; }

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

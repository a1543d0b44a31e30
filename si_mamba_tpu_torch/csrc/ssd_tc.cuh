// The block-level 3xTF32 tensor-core product that the chunk-parallel SSD
// kernels (csrc/ssd_xbc_fwd.cu, K8; csrc/ssd_xbc_bwd.cu, K9) are built from.
//
// One block of 256 threads (8 warps as 2 x 4) accumulates a 64 x BN tile
// (BN = 64 or 128) of C += A B over k-tiles of 32, with mma.sync m16n8k8 TF32.
// Each fp32 operand is split as hi = rna_tf32(v), lo = rna_tf32(v - hi), and
// a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi into the fp32 accumulator
// (the a_lo b_lo term, below 2^-22 of the product, is dropped): about 21 bits
// of each product where one TF32 product keeps 11, at three tensor-core
// products per product.
//
// Tiles land in shared memory through cp.async (16-byte copies where the
// operand's rows are 16-byte aligned, 4-byte copies otherwise) in a ring of
// kStages buffers, so the next tiles are in flight while the current one's
// products run. A tile is either [m][k] or [k][m] (A) and [k][n] or [n][k]
// (B), whichever the operand's rows in device memory give; each layout's row
// pitch is padded so that a warp's fragment reads fall in 32 distinct banks.
// An optional transform rewrites the landed A tile in place before its
// products (the decay mask, row or column factors), and a warp skips a k-tile
// whose A rows are all masked. Every sum runs in a fixed order: no atomics.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ssd_tc {

constexpr int kThreads = 256;
constexpr int kBM = 64;                 // rows of the output tile
constexpr int kBK = 32;                 // depth of a k-tile
constexpr int kStages = 3;              // cp.async ring
constexpr int kLdMK = kBK + 4;          // [m][k] or [n][k] pitch: k-contiguous reads
constexpr int kLdKM = kBM + 8;          // [k][m] pitch: m-contiguous reads
constexpr int kTileA = kBM * kLdMK;     // floats of an A tile in either layout
static_assert(kBM * kLdMK == kBK * kLdKM, "both A layouts take one tile size");

template <int BN>
struct Cfg {
  static constexpr int kWN = BN / 4;    // columns of a warp's tile
  static constexpr int kNT = kWN / 8;   // its n8 fragments
  static constexpr int kLdKN = BN + 8;  // [k][n] pitch
  static constexpr int kTileB = kBK * kLdKN > BN * kLdMK ? kBK * kLdKN : BN * kLdMK;
  static constexpr int kStage = kTileA + kTileB;
};
constexpr int kRingFloats = kStages * Cfg<128>::kStage;  // the ring for BN <= 128

template <int BN>
using Acc = float[2][Cfg<BN>::kNT][4];

// A row-strided operand in device memory: p at the tile's first element,
// rows ld floats apart, al when every row start is 16-byte aligned.
struct Src {
  const float* p;
  long long ld;
  bool al;
};

// Whether every row of an operand at p with batch stride sb and row stride sr
// (floats) starts 16-byte aligned, so its tiles can land by 16-byte copies.
inline bool aligned16(const void* p, long long sb, long long sr) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 && sr % 4 == 0;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool al) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (al) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s + 4 * i), "l"(src + i));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy an R x W block (W a multiple of 4) of rows of s into dst with pitch ld.
template <int R, int W>
__device__ __forceinline__ void load_tile(float* dst, int ld, Src s) {
  constexpr int kPerRow = W / 4;
#pragma unroll
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    cp_async(dst + r * ld + c, s.p + r * s.ld + c, s.al);
  }
}

// The A tile of a k-tile: rows m of s (kAKM false: 64 rows of 32) or rows k
// (kAKM true: 32 rows of 64).
template <bool kAKM>
__device__ __forceinline__ void load_a(float* dst, Src s) {
  if (kAKM)
    load_tile<kBK, kBM>(dst, kLdKM, s);
  else
    load_tile<kBM, kBK>(dst, kLdMK, s);
}

// The B tile: rows k of s (kBNK false: 32 rows of BN) or rows n (kBNK true:
// BN rows of 32).
template <int BN, bool kBNK>
__device__ __forceinline__ void load_b(float* dst, Src s) {
  if (kBNK)
    load_tile<BN, kBK>(dst, kLdMK, s);
  else
    load_tile<kBK, BN>(dst, Cfg<BN>::kLdKN, s);
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(v - __uint_as_float(h)));
  hi = h;
  lo = l;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += (the warp's 32 rows of sA) (the warp's kWN columns of sB) over one k-tile.
// Fragment layouts of m16n8k8 TF32: with g = lane / 4, t = lane % 4, A holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k t, n g), (k t + 4,
// n g); the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <int BN, bool kAKM, bool kBNK>
__device__ __forceinline__ void mma_ktile(Acc<BN>& acc, const float* sA, const float* sB,
                                          int wm, int wn, int lane) {
  using C = Cfg<BN>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t ah[2][4], al[2][4], bh[C::kNT][2], bl[C::kNT][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm * 32 + mi * 16 + g;
      float v[4];
      if (kAKM) {
        v[0] = sA[(kk + t) * kLdKM + r];
        v[1] = sA[(kk + t) * kLdKM + r + 8];
        v[2] = sA[(kk + t + 4) * kLdKM + r];
        v[3] = sA[(kk + t + 4) * kLdKM + r + 8];
      } else {
        v[0] = sA[r * kLdMK + kk + t];
        v[1] = sA[(r + 8) * kLdMK + kk + t];
        v[2] = sA[r * kLdMK + kk + t + 4];
        v[3] = sA[(r + 8) * kLdMK + kk + t + 4];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], ah[mi][i], al[mi][i]);
    }
#pragma unroll
    for (int ni = 0; ni < C::kNT; ++ni) {
      const int c = wn * C::kWN + ni * 8 + g;
      float w0, w1;
      if (kBNK) {
        w0 = sB[c * kLdMK + kk + t];
        w1 = sB[c * kLdMK + kk + t + 4];
      } else {
        w0 = sB[(kk + t) * C::kLdKN + c];
        w1 = sB[(kk + t + 4) * C::kLdKN + c];
      }
      split(w0, bh[ni][0], bl[ni][0]);
      split(w1, bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::kNT; ++ni) {
        mma_tf32(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
        mma_tf32(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
        mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
      }
  }
}

template <int BN>
__device__ __forceinline__ void zero(Acc<BN>& acc) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cfg<BN>::kNT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
}

// A transform that leaves the A tile as it landed.
struct NoXform {
  __device__ float operator()(int, int, int, float v) const { return v; }
};

// Every warp has work in every k-tile.
struct AllActive {
  __device__ bool operator()(int, int) const { return true; }
};

// acc += A B over kts k-tiles. src_a(kt) / src_b(kt) give the operands' rows
// for k-tile kt; xf(kt, m, k, v) rewrites each element (tile-local m, k) of
// a landed A tile (kXform); active(kt, wm) says whether warp row wm has any
// unmasked product in k-tile kt. ring: kRingFloats of shared memory that
// nothing else uses while this runs.
template <int BN, bool kAKM, bool kBNK, bool kXform, class SA, class SB, class XF, class ACT>
__device__ __forceinline__ void gemm(Acc<BN>& acc, float* ring, int kts, SA src_a, SB src_b,
                                     XF xf, ACT active) {
  using C = Cfg<BN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  __syncthreads();  // the ring is free: an earlier product may still be reading it
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kts) {
      load_a<kAKM>(ring + s * C::kStage, src_a(s));
      load_b<BN, kBNK>(ring + s * C::kStage + kTileA, src_b(s));
    }
    commit();
  }
  for (int kt = 0; kt < kts; ++kt) {
    wait_pending<kStages - 2>();
    __syncthreads();  // k-tile kt landed for every thread; k-tile kt - 1 is consumed
    float* sA = ring + (kt % kStages) * C::kStage;
    if (kXform) {
      for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
        int m, k;
        float* e;
        if (kAKM) {
          k = i / kBM;
          m = i % kBM;
          e = sA + k * kLdKM + m;
        } else {
          m = i / kBK;
          k = i % kBK;
          e = sA + m * kLdMK + k;
        }
        *e = xf(kt, m, k, *e);
      }
      __syncthreads();
    }
    const int nk = kt + kStages - 1;
    if (nk < kts) {
      float* d = ring + (nk % kStages) * C::kStage;
      load_a<kAKM>(d, src_a(nk));
      load_b<BN, kBNK>(d + kTileA, src_b(nk));
    }
    commit();
    if (active(kt, wm)) mma_ktile<BN, kAKM, kBNK>(acc, sA, sA + kTileA, wm, wn, lane);
  }
  wait_pending<0>();
}

// The place (m, n) in the 64 x BN tile of accumulator element [mi][ni][r].
template <int BN>
__device__ __forceinline__ void frag_pos(int mi, int ni, int r, int& m, int& n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  m = (warp >> 2) * 32 + mi * 16 + (lane >> 2) + (r >> 1) * 8;
  n = (warp & 3) * Cfg<BN>::kWN + ni * 8 + 2 * (lane & 3) + (r & 1);
}

// f(m, n, element) for every accumulator element.
template <int BN, class F>
__device__ __forceinline__ void for_each(Acc<BN>& acc, F f) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < Cfg<BN>::kNT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int m, n;
        frag_pos<BN>(mi, ni, r, m, n);
        f(m, n, acc[mi][ni][r]);
      }
}

// out[m] = sum over the tile's n of v(m, n, acc), for the 64 rows, in a fixed
// order (the warp's columns, the 4 lanes of a row, then the 4 warp columns).
// red: 4 * 64 floats. Ends synchronised: out is readable by every thread.
template <int BN, class V>
__device__ __forceinline__ void row_sums(Acc<BN>& acc, V v, float* red, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  float part[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * 32 + mi * 16 + g + h * 8;
      float s = 0.f;
#pragma unroll
      for (int ni = 0; ni < Cfg<BN>::kNT; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          s += v(m, wn * Cfg<BN>::kWN + ni * 8 + 2 * t + j, acc[mi][ni][2 * h + j]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      part[mi][h] = s;
    }
  __syncthreads();  // red is free
  if (t == 0) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) red[wn * kBM + wm * 32 + mi * 16 + g + h * 8] = part[mi][h];
  }
  __syncthreads();
  if (threadIdx.x < kBM)
    out[threadIdx.x] = ((red[threadIdx.x] + red[kBM + threadIdx.x]) + red[2 * kBM + threadIdx.x]) +
                       red[3 * kBM + threadIdx.x];
  __syncthreads();
}

// out[n] = sum over the 64 rows of v(m, n, acc), for the BN columns, in a
// fixed order. red: 2 * BN floats. Ends synchronised.
template <int BN, class V>
__device__ __forceinline__ void col_sums(Acc<BN>& acc, V v, float* red, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  float part[Cfg<BN>::kNT][2];
#pragma unroll
  for (int ni = 0; ni < Cfg<BN>::kNT; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = wn * Cfg<BN>::kWN + ni * 8 + 2 * t + j;
      float s = 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          s += v(wm * 32 + mi * 16 + g + h * 8, n, acc[mi][ni][2 * h + j]);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      part[ni][j] = s;
    }
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < Cfg<BN>::kNT; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        red[wm * BN + wn * Cfg<BN>::kWN + ni * 8 + 2 * t + j] = part[ni][j];
  }
  __syncthreads();
  if (threadIdx.x < BN) out[threadIdx.x] = red[threadIdx.x] + red[BN + threadIdx.x];
  __syncthreads();
}

// The sum of v over the block's threads, the same in every thread, in a fixed
// order. red: 8 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Tile pair index of (ti, si), si <= ti, over a chunk's lower triangle of
// 64 x 64 tiles, and back.
__host__ __device__ __forceinline__ int pair_index(int ti, int si) {
  return ti * (ti + 1) / 2 + si;
}
__device__ __forceinline__ void pair_tiles(int pi, int& ti, int& si) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= pi) ++ti;
  si = pi - ti * (ti + 1) / 2;
}

// G = C B^T of one 64 x 64 tile pair (ti, si) of a chunk, K = 128 state
// channels: Cs and Bs at the chunk's first C and B rows; written row-major to
// the chunk's (q, q) block Gc. Diagonal tiles are computed whole.
__device__ __forceinline__ void g_tile(float* ring, Src Cs, Src Bs, int ti, int si, float* Gc,
                                       int Q) {
  Acc<64> acc;
  zero<64>(acc);
  const int t0 = ti * kBM, s0 = si * kBM;
  gemm<64, false, true, false>(
      acc, ring, 128 / kBK, [=](int kt) { return Src{Cs.p + t0 * Cs.ld + kt * kBK, Cs.ld, Cs.al}; },
      [=](int kt) { return Src{Bs.p + s0 * Bs.ld + kt * kBK, Bs.ld, Bs.al}; }, NoXform{},
      AllActive{});
  for_each<64>(acc, [=](int m, int n, float v) {
    Gc[(t0 + m) * static_cast<long long>(Q) + s0 + n] = v;
  });
}

}  // namespace ssd_tc

// The block-level tensor-core products that the chunk-parallel SSD kernels
// (csrc/ssd_xbc_fwd.cu: K8, K6; csrc/ssd_xbc_bwd.cu: K9, K7) are built from.
//
// One block of 256 threads (8 warps as 2 x 4) accumulates a 64 x BN tile
// (BN = 64 or 128) of C += A B into fp32 over k-tiles of 32, in one of two
// product kinds (kBf16):
//  - 3xTF32, mma.sync m16n8k8 TF32: each fp32 operand is split as
//    hi = rna_tf32(v), lo = rna_tf32(v - hi), and a b is taken as
//    a_lo b_hi + a_hi b_lo + a_hi b_hi (the a_lo b_lo term, below 2^-22 of the
//    product, is dropped): about 21 bits of each product where one TF32
//    product keeps 11, at three tensor-core products per product. A bf16
//    operand is exact in TF32 (its lo is 0), so its lo term is skipped;
//  - bf16, mma.sync m16n8k16 bf16 with fp32 accumulators: each operand
//    rounded to bf16 (to nearest even) where its tile is fp32, one product
//    per product; what the TPU kernels' `mm` (the activation dtype) products
//    are at bf16 input.
//
// Tiles land in shared memory through cp.async (16-byte copies where the
// operand's rows are 16-byte aligned, 4-byte copies otherwise) in a ring of
// kStages buffers, so the next tiles are in flight while the current one's
// products run. An operand's tile holds its own element type (fp32 or bf16,
// half the bytes), or fp32 widened from bf16 in device memory (then loaded
// element by element, not through cp.async: the one fp32 product with a bf16
// operand and a factor along k). A tile is either [m][k] or [k][m] (A) and
// [k][n] or [n][k] (B), whichever the operand's rows in device memory give;
// each layout's row pitch is padded so that a warp's fragment reads spread
// over the banks and (bf16) every row starts 16-byte aligned. An optional
// transform rewrites the landed A or B tile in place before its products
// (the decay mask, row or column factors, a rounding to bf16), and a warp
// skips a k-tile whose A rows are all masked. Every sum runs in a fixed
// order: no atomics.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "elem.cuh"

namespace ssd_tc {

constexpr int kThreads = 256;
constexpr int kBM = 64;                 // rows of the output tile
constexpr int kBK = 32;                 // depth of a k-tile
constexpr int kStages = 3;              // cp.async ring

// Row pitches, in elements of the tile's type: [m][k] or [n][k] (k-contiguous
// reads), [k][m] (m-contiguous) and [k][n].
template <class T>
struct Pitch;
template <>
struct Pitch<float> {
  static constexpr int kMK = kBK + 4, kKM = kBM + 8;
  template <int BN>
  static constexpr int kKN = BN + 8;
};
template <>
struct Pitch<bf16> {
  static constexpr int kMK = kBK + 8, kKM = kBM + 8;  // 80- and 144-byte rows
  template <int BN>
  static constexpr int kKN = BN + 8;
};

constexpr int kTileA = kBM * Pitch<float>::kMK;  // floats of an A slot, either layout
static_assert(kBM * Pitch<float>::kMK == kBK * Pitch<float>::kKM,
              "both fp32 A layouts take one slot size");

template <int BN>
struct Cfg {
  static constexpr int kWN = BN / 4;    // columns of a warp's tile
  static constexpr int kNT = kWN / 8;   // its n8 fragments
  static constexpr int kLdKN = Pitch<float>::kKN<BN>;
  static constexpr int kTileB = kBK * kLdKN > BN * Pitch<float>::kMK ? kBK * kLdKN
                                                                     : BN * Pitch<float>::kMK;
  static constexpr int kStage = kTileA + kTileB;
};
constexpr int kRingFloats = kStages * Cfg<128>::kStage;  // the ring for BN <= 128
// a bf16 tile fits the slot of the fp32 one
static_assert(2 * kBM * Pitch<bf16>::kMK <= 4 * kTileA, "bf16 A tile");
static_assert(2 * 128 * Pitch<bf16>::kMK <= 4 * Cfg<128>::kTileB, "bf16 B tile");

template <int BN>
using Acc = float[2][Cfg<BN>::kNT][4];

// A row-strided operand in device memory: p at the tile's first element,
// rows ld elements apart, al when every row start is 16-byte aligned (else
// every row start is 4-byte aligned).
template <class T>
struct Src {
  const T* p;
  long long ld;
  bool al;
};

// Whether every row of an operand of T at p with batch stride sb and row
// stride sr (elements) starts 16-byte aligned, so its tiles can land by
// 16-byte copies.
template <class T = float>
inline bool aligned16(const void* p, long long sb, long long sr) {
  constexpr long long e = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % e == 0 && sr % e == 0;
}

// Whether every row starts 4-byte aligned: what the 4-byte copies need.
template <class T>
inline bool aligned4(const void* p, long long sb, long long sr) {
  constexpr long long e = 4 / sizeof(T) > 0 ? 4 / sizeof(T) : 1;
  return reinterpret_cast<uintptr_t>(p) % 4 == 0 && sb % e == 0 && sr % e == 0;
}

// 16 bytes from src to dst (shared memory), as one copy or four.
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool al) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (al) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    const char* c = static_cast<const char*>(src);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s + 4 * i), "l"(c + 4 * i));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy an R x W block of rows of s into dst with pitch ld (elements). A tile
// of the operand's own type lands by cp.async, 16 bytes at a time (W a
// multiple of 16 bytes); an fp32 tile of a bf16 operand is widened element by
// element.
template <int R, int W, class TS, class TG>
__device__ __forceinline__ void load_tile(TS* dst, int ld, Src<TG> s) {
  if constexpr (std::is_same<TS, TG>::value) {
    constexpr int kE = 16 / sizeof(TS), kPerRow = W / kE;
    static_assert(W % kE == 0, "rows of whole 16-byte pieces");
#pragma unroll
    for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kE;
      cp_async(dst + r * ld + c, s.p + r * s.ld + c, s.al);
    }
  } else {
    static_assert(std::is_same<TS, float>::value && std::is_same<TG, bf16>::value,
                  "only bf16 widens");
#pragma unroll
    for (int i = threadIdx.x; i < R * W; i += kThreads) {
      const int r = i / W, c = i % W;
      dst[r * ld + c] = to_f(s.p[r * s.ld + c]);
    }
  }
}

// The A tile of a k-tile: rows m of s (kAKM false: 64 rows of 32) or rows k
// (kAKM true: 32 rows of 64).
template <bool kAKM, class TS, class TG>
__device__ __forceinline__ void load_a(TS* dst, Src<TG> s) {
  if (kAKM)
    load_tile<kBK, kBM>(dst, Pitch<TS>::kKM, s);
  else
    load_tile<kBM, kBK>(dst, Pitch<TS>::kMK, s);
}

// The B tile: rows k of s (kBNK false: 32 rows of BN) or rows n (kBNK true:
// BN rows of 32).
template <int BN, bool kBNK, class TS, class TG>
__device__ __forceinline__ void load_b(TS* dst, Src<TG> s) {
  if (kBNK)
    load_tile<BN, kBK>(dst, Pitch<TS>::kMK, s);
  else
    load_tile<kBK, BN>(dst, Pitch<TS>::template kKN<BN>, s);
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element (m, k) of a landed A tile and (k, n) of a landed B tile, as fp32.
template <bool kAKM, class T>
__device__ __forceinline__ float a_at(const T* sA, int m, int k) {
  return to_f(kAKM ? sA[k * Pitch<T>::kKM + m] : sA[m * Pitch<T>::kMK + k]);
}
template <int BN, bool kBNK, class T>
__device__ __forceinline__ float b_at(const T* sB, int k, int n) {
  return to_f(kBNK ? sB[n * Pitch<T>::kMK + k] : sB[k * Pitch<T>::template kKN<BN> + n]);
}

// Elements k and k + 1 of row m of A (or of column n of B) as a bf16 pair,
// the lower k in the low half: one 32-bit read where the tile is bf16 and k
// runs along its rows, else two elements rounded to bf16.
template <bool kAKM, class T>
__device__ __forceinline__ uint32_t a_pair(const T* sA, int m, int k) {
  if constexpr (std::is_same<T, bf16>::value && !kAKM)
    return *reinterpret_cast<const uint32_t*>(sA + m * Pitch<T>::kMK + k);
  else
    return pack_bf16(a_at<kAKM>(sA, m, k), a_at<kAKM>(sA, m, k + 1));
}
template <int BN, bool kBNK, class T>
__device__ __forceinline__ uint32_t b_pair(const T* sB, int k, int n) {
  if constexpr (std::is_same<T, bf16>::value && kBNK)
    return *reinterpret_cast<const uint32_t*>(sB + n * Pitch<T>::kMK + k);
  else
    return pack_bf16(b_at<BN, kBNK>(sB, k, n), b_at<BN, kBNK>(sB, k + 1, n));
}

// acc += (the warp's 32 rows of sA) (the warp's kWN columns of sB) over one
// k-tile. Fragment layouts, with g = lane / 4, t = lane % 4: m16n8k8 TF32: A
// holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k t, n g),
// (k t + 4, n g). m16n8k16 bf16: A holds the pairs (g, 2t..2t+1),
// (g + 8, 2t..), (g, 2t+8..), (g + 8, 2t+8..); B the pairs (k 2t..2t+1, n g),
// (k 2t+8..2t+9, n g). The accumulator, both kinds: (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
template <int BN, bool kAKM, bool kBNK, bool kBf16, class TA, class TB>
__device__ __forceinline__ void mma_ktile(Acc<BN>& acc, const TA* sA, const TB* sB, int wm,
                                          int wn, int lane) {
  using C = Cfg<BN>;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[C::kNT][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        a[mi][0] = a_pair<kAKM>(sA, r, kk + 2 * t);
        a[mi][1] = a_pair<kAKM>(sA, r + 8, kk + 2 * t);
        a[mi][2] = a_pair<kAKM>(sA, r, kk + 2 * t + 8);
        a[mi][3] = a_pair<kAKM>(sA, r + 8, kk + 2 * t + 8);
      }
#pragma unroll
      for (int ni = 0; ni < C::kNT; ++ni) {
        const int c = wn * C::kWN + ni * 8 + g;
        b[ni][0] = b_pair<BN, kBNK>(sB, kk + 2 * t, c);
        b[ni][1] = b_pair<BN, kBNK>(sB, kk + 2 * t + 8, c);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::kNT; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  } else {
    constexpr bool kAExact = std::is_same<TA, bf16>::value;  // lo parts 0
    constexpr bool kBExact = std::is_same<TB, bf16>::value;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[C::kNT][2], bl[C::kNT][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        const float v[4] = {a_at<kAKM>(sA, r, kk + t), a_at<kAKM>(sA, r + 8, kk + t),
                            a_at<kAKM>(sA, r, kk + t + 4), a_at<kAKM>(sA, r + 8, kk + t + 4)};
#pragma unroll
        for (int i = 0; i < 4; ++i) split(v[i], ah[mi][i], al[mi][i]);
      }
#pragma unroll
      for (int ni = 0; ni < C::kNT; ++ni) {
        const int c = wn * C::kWN + ni * 8 + g;
        split(b_at<BN, kBNK>(sB, kk + t, c), bh[ni][0], bl[ni][0]);
        split(b_at<BN, kBNK>(sB, kk + t + 4, c), bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::kNT; ++ni) {
          if (!kAExact) mma_tf32(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
          if (!kBExact) mma_tf32(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
          mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
        }
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

// A transform that leaves a tile as it landed.
struct NoXform {
  __device__ float operator()(int, int, int, float v) const { return v; }
};

// Every warp has work in every k-tile.
struct AllActive {
  __device__ bool operator()(int, int) const { return true; }
};

// The operands' tile types of a product: T for a bf16 product (the
// activations' element type), fp32 for 3xTF32.
template <class T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

// acc += A B over kts k-tiles, as bf16 products (kBf16) or 3xTF32. TA / TB:
// the element types of the A and B tiles in shared memory. src_a(kt) /
// src_b(kt) give the operands' rows for k-tile kt (Src of TA, or Src of bf16
// for an fp32 tile that widens it); xa(kt, m, k, v) and xb(kt, k, n, v)
// rewrite each element (tile-local) of a landed A or B tile, rounded back to
// the tile's type (NoXform: none); active(kt, wm) says whether warp row wm
// has any unmasked product in k-tile kt. ring: kRingFloats of shared memory
// that nothing else uses while this runs.
template <int BN, bool kAKM, bool kBNK, bool kBf16, class TA, class TB, class SA, class SB,
          class XA, class XB, class ACT>
__device__ __forceinline__ void gemm(Acc<BN>& acc, float* ring, int kts, SA src_a, SB src_b,
                                     XA xa, XB xb, ACT active) {
  using C = Cfg<BN>;
  constexpr bool kXA = !std::is_same<XA, NoXform>::value;
  constexpr bool kXB = !std::is_same<XB, NoXform>::value;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  auto slot_a = [&](int kt) { return reinterpret_cast<TA*>(ring + (kt % kStages) * C::kStage); };
  auto slot_b = [&](int kt) {
    return reinterpret_cast<TB*>(ring + (kt % kStages) * C::kStage + kTileA);
  };
  __syncthreads();  // the ring is free: an earlier product may still be reading it
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kts) {
      load_a<kAKM>(slot_a(s), src_a(s));
      load_b<BN, kBNK>(slot_b(s), src_b(s));
    }
    commit();
  }
  for (int kt = 0; kt < kts; ++kt) {
    wait_pending<kStages - 2>();
    __syncthreads();  // k-tile kt landed for every thread; k-tile kt - 1 is consumed
    TA* sA = slot_a(kt);
    TB* sB = slot_b(kt);
    if constexpr (kXA) {
      for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
        const int m = kAKM ? i % kBM : i / kBK, k = kAKM ? i / kBM : i % kBK;
        TA* e = kAKM ? sA + k * Pitch<TA>::kKM + m : sA + m * Pitch<TA>::kMK + k;
        *e = from_f<TA>(xa(kt, m, k, to_f(*e)));
      }
    }
    if constexpr (kXB) {
      for (int i = threadIdx.x; i < kBK * BN; i += kThreads) {
        const int k = kBNK ? i % kBK : i / BN, n = kBNK ? i / kBK : i % BN;
        TB* e = kBNK ? sB + n * Pitch<TB>::kMK + k : sB + k * Pitch<TB>::template kKN<BN> + n;
        *e = from_f<TB>(xb(kt, k, n, to_f(*e)));
      }
    }
    if constexpr (kXA || kXB) __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < kts) {
      load_a<kAKM>(slot_a(nk), src_a(nk));
      load_b<BN, kBNK>(slot_b(nk), src_b(nk));
    }
    commit();
    if (active(kt, wm)) mma_ktile<BN, kAKM, kBNK, kBf16>(acc, sA, sB, wm, wn, lane);
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

// G = C B^T of one 64 x 64 tile pair (ti, si) of a chunk, over N state
// channels (a multiple of kBK): Cs and Bs at the chunk's first C and B rows
// (T: fp32, 3xTF32 products; bf16, bf16 products); G is written in fp32,
// row-major, to the chunk's (q, q) block Gc. Diagonal tiles are computed whole.
template <class T>
__device__ __forceinline__ void g_tile(float* ring, Src<T> Cs, Src<T> Bs, int ti, int si,
                                       float* Gc, int Q, int N) {
  Acc<64> acc;
  zero<64>(acc);
  const int t0 = ti * kBM, s0 = si * kBM;
  gemm<64, false, true, is_bf16<T>, T, T>(
      acc, ring, N / kBK,
      [=](int kt) { return Src<T>{Cs.p + t0 * Cs.ld + kt * kBK, Cs.ld, Cs.al}; },
      [=](int kt) { return Src<T>{Bs.p + s0 * Bs.ld + kt * kBK, Bs.ld, Bs.al}; }, NoXform{},
      NoXform{}, AllActive{});
  for_each<64>(acc, [=](int m, int n, float v) {
    Gc[(t0 + m) * static_cast<long long>(Q) + s0 + n] = v;
  });
}

}  // namespace ssd_tc

// What the mma.sync attention kernels of this directory share: the tile
// sizes, the mma.sync bf16 product, and the loads of 64-row tiles of one
// head into shared memory. Included by flash_attn_nhd.cu (K4's kernel) and
// cross_attn_nhd.cu (K2); the Hopper kernels (K1, K3) use sm90_tiles.cuh.
// build.library_path hashes every header with each source, so an edit here
// rebuilds them all.
//
// Layouts: every operand is addressed as base + b*batch + h*head + row*row
// (element strides, `Strides`) with unit stride along the head dim, so
// packed (B, S, H*D) tensors, column views of a packed projection output and
// head-split (B, H, S, D) views all go in with no copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 64;   // query rows per tile
constexpr int kBlockN = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 elements of row padding (bank spread)

// Element strides of one operand: between batches, heads and rows.
struct Strides {
  int64_t batch, head, row;
};

// Products over the head dim take 16 columns a step: D rounded up to 16
// (40 -> 48). The columns from D up are zero in shared memory only.
template <int D>
constexpr int kContraction = (D + 15) / 16 * 16;

// Row pitch of a row-major tile, in elements.
template <int D>
constexpr int kPitch = kContraction<D> + kPad;

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0+64) of one head into a row-major shared tile (pitch
// kPitch<D>), each element times `mul` unless mul is 1, zero-filling rows >=
// n_rows and the columns from D up to the contraction width: zero, never
// garbage, since a product reads them (0 * NaN is NaN). 16-byte loads.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t row_stride,
                                          int row0, int n_rows, float mul = 1.f) {
  constexpr int kChunks = kContraction<D> / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBlockN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && c < D) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + c);
      if (mul != 1.f) {
        const bf16* e = reinterpret_cast<const bf16*>(&val);
        uint4 scaled;
        uint32_t* o = reinterpret_cast<uint32_t*>(&scaled);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = pack_bf16(__bfloat162float(e[2 * j]) * mul, __bfloat162float(e[2 * j + 1]) * mul);
        }
        val = scaled;
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kPitch<D> + c) = val;
  }
}

// The same rows stored transposed: dst[d][row], pitch kBlockN + kPad, for
// products over the 64-row axis. Rows >= n_rows are zero, never garbage.
template <int D>
__device__ __forceinline__ void load_tile_t(bf16* dst, const bf16* src, int64_t row_stride,
                                            int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBlockN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + c);
    }
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * (kBlockN + kPad) + r] = e[j];
  }
}

// mma A-fragments of the 16-row slab starting at `rows` of a row-major
// shared tile, for the contraction step kk (columns kk*16 .. kk*16+15).
template <int D>
__device__ __forceinline__ void load_a_frag(uint32_t (&f)[4], const bf16* rows, int kk, int g,
                                            int t) {
  const bf16* p0 = rows + g * kPitch<D> + kk * 16 + 2 * t;
  const bf16* p1 = p0 + 8 * kPitch<D>;
  f[0] = ld32(p0);
  f[1] = ld32(p1);
  f[2] = ld32(p0 + 8);
  f[3] = ld32(p1 + 8);
}

// out[nd] (16 x D) += X . tile_t^T over the 64-wide axis, with X (16 x 64)
// in accumulator layout, rounded to bf16 here, and tile_t a transposed tile
// (D rows of 64, pitch 64 + kPad). The accumulator layout of one product is
// the A-operand layout of the next, so X never leaves registers.
template <int D>
__device__ __forceinline__ void mma_cols(float (&out)[D / 8][4], const float (&x)[kBlockN / 8][4],
                                         const bf16* tile_t, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    uint32_t xf[4];
    xf[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    xf[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    xf[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xf[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const bf16* col = tile_t + (nd * 8 + g) * (kBlockN + kPad) + kk * 16 + 2 * t;
      mma_bf16_16816(out[nd], xf, ld32(col), ld32(col + 8));
    }
  }
}

// Rows g and g + 8 of a warp's (16 x D) accumulator, from row0 on, times
// mul[r], stored as bf16 to one head of dst; rows >= n_rows are not stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, Strides st, const float (&acc)[D / 8][4],
                                           const float (&mul)[2], int b, int h, int n_rows,
                                           int row0, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    bf16* out = dst + b * st.batch + h * st.head + row * st.row;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(out + nd * 8 + 2 * t) =
          pack_bf16(acc[nd][2 * r] * mul[r], acc[nd][2 * r + 1] * mul[r]);
    }
  }
}

}  // namespace

// K1 and K4: fused self-attention, bf16 in and out. One device kernel under
// two entry points that differ only in the strides they hand it:
//
//   * K1, `flash_attn_nhd_bf16`: the packed (B, S, H*D) layout, head h at
//     column h*D. Replaces the TPU kernel `_attn_nhd_kernel` (imagharmony_tpu/
//     kernels/flash_attention.py:415), reached through `flash_attention_nhd`
//     (:576). Head dims 32, 64, 128.
//   * K4, `flash_attn_bhsd_bf16`: the head-split (B, H, S, D) layout with a
//     batch, head and row stride for q, k, v and the output. Replaces the TPU
//     kernel `_attn_kernel` (:95), reached through `flash_attention` (:369) ->
//     `_flash_fwd_impl` (:138). Head dims 40, 80, 160 as well: the QK^T
//     contraction runs over D rounded up to 16 with the extra columns zero in
//     shared memory only, so nothing is padded in device memory (the Pallas
//     kernel pads D to a multiple of 64 and Sk to 256 on the host).
//
// Unlike the Pallas kernels it computes the exact softmax: a running row max
// and sum (online softmax), no clamp on the exp2 argument, and no padding
// of the sequence on the host (ragged key columns and query rows are masked
// here).
//
// What bounds it on an H100: at head_dim 64 the work is 4*B*H*Sq*Sk*D flops
// against (3+1)*B*S*H*D*2 bytes, e.g. S=4096, H=10, B=2: 86 GFLOP against
// 42 MB, about 2000 flop/byte, far above the card's ~295 flop/byte ridge. So
// it is bound by the tensor cores, and the design keeps the (Sq, Sk) logits
// out of device memory entirely: they live in registers, one 64-key tile at
// a time.
//
// Design (simple and correct first; wgmma/TMA/warp specialisation are later
// work):
//   * grid (ceil(Sq/64), H, B); one CTA of 4 warps per 64 query rows of one
//     head; each warp owns 16 query rows.
//   * K and V tiles of 64 rows are staged in shared memory (V transposed, so
//     the PV operand is a plain 32-bit load); Q goes through shared memory
//     once into registers, pre-scaled by scale*log2(e) as the Pallas kernel
//     does (:428).
//   * QK^T and PV are mma.sync.m16n8k16 bf16 products with fp32
//     accumulation; P is rounded to bf16 before PV.
//   * q, k and v take a row, a head and a batch stride, so they can be column
//     slices of one packed to_qkv output (row stride 3*H*D, head stride D)
//     with no copy. The output takes the same three strides; both wrappers
//     hand it a contiguous (B, Sq, H*D) buffer.
//   * optionally (lse != nullptr, under either entry point) the row
//     log-sum-exp in the scaled-log2 domain, lse = m + log2(l) with m the row
//     max of s = q.k*scale*log2(e) and l = sum exp2(s - m), fp32 (B, H, Sq):
//     what the backward (K3, flash_attn_nhd_bwd.cu) needs to recompute
//     P = exp2(s - lse). A null pointer writes nothing, so inference pays
//     nothing for it.
//   * the tile loads and the mma helpers are attn_tiles.cuh's, shared with
//     K2 and K3.

#include "attn_tiles.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const bf16* __restrict__ q,
                  const bf16* __restrict__ k,
                  const bf16* __restrict__ v,
                  bf16* __restrict__ o,
                  float* __restrict__ lse,
                  int sq, int sk, int heads,
                  Strides qs, Strides ks, Strides vs, Strides os,
                  float scale_log2) {
  constexpr int kDK = kContraction<D>;
  // sK holds Q first (same shape), then each K tile. 44.5 KB together at
  // D=160, under the 48 KB a kernel may declare statically.
  __shared__ __align__(16) bf16 sK[kBlockN * kPitch<D>];
  __shared__ __align__(16) bf16 sVt[D * (kBlockN + kPad)];

  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // mma group: row within the 8-row slab
  const int t = lane % 4;   // thread in group: column pair

  const bf16* qh = q + b * qs.batch + h * qs.head;
  const bf16* kh = k + b * ks.batch + h * ks.head;
  const bf16* vh = v + b * vs.batch + h * vs.head;

  // ---- Q fragments (A operand), pre-scaled by scale*log2(e) ----
  load_tile<D>(sK, qh, qs.row, m0, sq, scale_log2);
  __syncthreads();
  uint32_t qf[kDK / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDK / 16; ++kk) {
    load_a_frag<D>(qf[kk], sK + warp * 16 * kPitch<D>, kk, g, t);
  }
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;
  // rows g and g+8 of this warp's 16
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  for (int n0 = 0; n0 < sk; n0 += kBlockN) {
    load_tile<D>(sK, kh, ks.row, n0, sk);
    load_tile_t<D>(sVt, vh, vs.row, n0, sk);
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 keys (log2 domain) ----
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
      const bf16* krow = sK + (nb * 8 + g) * kPitch<D>;
#pragma unroll
      for (int kk = 0; kk < kDK / 16; ++kk) {
        const uint32_t b0 = ld32(krow + kk * 16 + 2 * t);
        const uint32_t b1 = ld32(krow + kk * 16 + 8 + 2 * t);
        mma_bf16_16816(s[nb], qf[kk], b0, b1);
      }
    }

    // ---- mask the ragged key edge, then the online-softmax update ----
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nb * 8 + 2 * t + (i & 1);
        if (col >= sk) s[nb][i] = -INFINITY;
        tile_max[i >> 1] = fmaxf(tile_max[i >> 1], s[nb][i]);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a group hold the same row
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(row_max[r], tile_max[r]);
      // a row with no valid key yet keeps max -inf: use 0 as the base so
      // exp2(-inf - 0) = 0 and no inf - inf NaN appears
      m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[r] = exp2f(row_max[r] - m_use[r]);
      row_max[r] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[nb][i] - m_use[i >> 1]);
        s[nb][i] = p;
        tile_sum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 1);
      tile_sum[r] += __shfl_xor_sync(0xffffffffu, tile_sum[r], 2);
      row_sum[r] = row_sum[r] * alpha[r] + tile_sum[r];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // ---- O += P V: the S accumulator layout is the A-operand layout ----
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const bf16* vrow = sVt + (nd * 8 + g) * (kBlockN + kPad) + kk * 16;
        const uint32_t b0 = ld32(vrow + 2 * t);
        const uint32_t b1 = ld32(vrow + 8 + 2 * t);
        mma_bf16_16816(acc[nd], pf, b0, b1);
      }
    }
    __syncthreads();  // before the next tile overwrites sK / sVt
  }

  // ---- normalise and store rows < sq (and their lse, if asked) ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    if (lse != nullptr && t == 0) {
      lse[((int64_t)b * heads + h) * sq + row] = row_max[r] + log2f(row_sum[r]);
    }
    const float inv = row_sum[r] > 0.f ? 1.f / row_sum[r] : 0.f;
    bf16* orow = o + b * os.batch + h * os.head + row * os.row;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const uint32_t val = pack_bf16(acc[nd][2 * r] * inv, acc[nd][2 * r + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + 2 * t) = val;
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int batch, sq, sk, heads;
  Strides qs, ks, vs, os;
  float scale_log2;
  cudaStream_t stream;
};

template <int D>
void launch(const Args& a) {
  dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.heads, a.batch);
  flash_attn_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.sq,
      a.sk, a.heads, a.qs, a.ks, a.vs, a.os, a.scale_log2);
}

// Launch at head_dim; `odd_dims` also admits 40, 80 and 160. Returns
// cudaGetLastError() after the launch (0 on success); an unsupported head_dim
// or an empty shape returns cudaErrorInvalidValue without launching.
int dispatch(const Args& a, int head_dim, bool odd_dims) {
  if (a.batch <= 0 || a.sq <= 0 || a.sk <= 0 || a.heads <= 0 || a.heads > 65535 ||
      a.batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (!odd_dims && head_dim % 32) return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 32: launch<32>(a); break;
    case 40: launch<40>(a); break;
    case 64: launch<64>(a); break;
    case 80: launch<80>(a); break;
    case 128: launch<128>(a); break;
    case 160: launch<160>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Strides are in elements.

// K1: packed (B, S, H*D) q, k, v with a row and a batch stride each; o is a
// contiguous (B, Sq, H*D) buffer; lse is null or a contiguous fp32 (B, H, Sq)
// buffer. head_dim 32, 64 or 128.
extern "C" int flash_attn_nhd_bf16(const void* q, const void* k, const void* v, void* o,
                                   float* lse,
                                   int batch, int sq, int sk, int heads, int head_dim,
                                   long long q_row, long long k_row, long long v_row,
                                   long long q_batch, long long k_batch,
                                   long long v_batch, float scale_log2, void* stream) {
  const long long hd = (long long)heads * head_dim;
  const Args a{q, k, v, o, lse, batch, sq, sk, heads,
               {q_batch, head_dim, q_row}, {k_batch, head_dim, k_row},
               {v_batch, head_dim, v_row}, {sq * hd, head_dim, hd},
               scale_log2, static_cast<cudaStream_t>(stream)};
  return dispatch(a, head_dim, false);
}

// K4: head-split (B, H, S, D) q, k, v and o, each with a batch, a head and a
// row stride (unit stride along D); lse as for K1. head_dim 32, 40, 64, 80,
// 128 or 160.
extern "C" int flash_attn_bhsd_bf16(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int batch, int sq, int sk, int heads, int head_dim,
                                    long long q_batch, long long q_head, long long q_row,
                                    long long k_batch, long long k_head, long long k_row,
                                    long long v_batch, long long v_head, long long v_row,
                                    long long o_batch, long long o_head, long long o_row,
                                    float scale_log2, void* stream) {
  const Args a{q, k, v, o, lse, batch, sq, sk, heads,
               {q_batch, q_head, q_row}, {k_batch, k_head, k_row},
               {v_batch, v_head, v_row}, {o_batch, o_head, o_row},
               scale_log2, static_cast<cudaStream_t>(stream)};
  return dispatch(a, head_dim, true);
}

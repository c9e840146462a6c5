// K2: fused cross-attention with the decoupled image-prompt (IP) branch,
// bf16 in and out, fp32 accumulation:
//
//   out = softmax(q k^T * scale) v + ip_scale * softmax(q k_ip^T * scale) v_ip
//
// per head, in one pass over q; without k_ip/v_ip, the text branch alone.
// Replaces the TPU kernel `_cross_ip_nhd_kernel` (imagharmony_tpu/kernels/
// flash_attention.py:630), reached through `flash_cross_nhd` (:795) ->
// `_cross_nhd_impl` (:670). The Pallas kernel packs heads into 128 lanes,
// pads the keys to 128 on the host, computes exp2 in bf16 and wants v_ip
// pre-scaled by ip_scale in device memory. This one computes what the port's
// model computes: the exact fp32 softmax of each branch, each with its own
// max and normaliser, ip_scale as an argument, the ragged key edges (77 text
// keys; 4, 16 or 257 IP keys) and query rows masked here, nothing padded in
// device memory.
//
// What bounds it on an H100: bytes. The keys are few, so the work is
// 4*B*H*Sq*(Sk + Sk_ip)*D flops against q and the output (2*B*Sq*H*D bf16
// each way) plus the small K/V: at SDXL's (B, Sq, H, D) = (2, 4096, 10, 64)
// with 77 + 4 keys, 1.7 GFLOP (1.7 us at 989 TFLOP/s) against ~21.4 MB
// (6.4 us at 3.35 TB/s). The design therefore reads q once and writes the
// output once, and never writes logits or probabilities to device memory;
// the few K/V tiles of a head are re-read from L2 by each q tile.
//
// Design (simple and correct first):
//   * grid (ceil(Sq/64), H, B); one CTA of 4 warps per 64 query rows of one
//     head; each warp owns 16 rows. Q goes through shared memory once into
//     registers, pre-scaled by scale*log2(e) and rounded to bf16, as in K1.
//   * Each branch takes two passes over its 64-key tiles: QK^T alone for the
//     row max m and sum l, then QK^T again, P = exp2(s - m) * w with
//     w = branch_scale / l, rounded to bf16, and PV added into the output
//     accumulator. So one fp32 accumulator serves both branches (80
//     registers a thread at D=160, where a second one would spill), the
//     branch arrives normalised and scaled (w = 1 for text, ip_scale for IP;
//     ip_scale = 0 adds exactly 0), and there is no online rescaling. The
//     second QK^T is cheap: at most 257 keys.
//   * Masked key columns get s = -inf, so P is exactly 0 there; K and V rows
//     past the edge are zero in shared memory (a zero P times garbage could
//     still be NaN).
//   * Head dims 32, 40, 64, 80, 128, 160: the QK^T contraction runs over D
//     rounded up to 16 with zero columns in shared memory only, as in K4.
//   * Every operand takes a batch, a head and a row stride: q is the to_q
//     output, k and v column views of the packed to_kv output (row stride
//     2*H*D), k_ip and v_ip the IP projections, and the output the packed
//     (B, Sq, H*D) buffer that to_out reads, all with no copy.

#include "attn_tiles.cuh"

namespace {

// s = Qs K^T for this warp's 16 rows against the 64-key tile in sK that
// starts at key n0 (log2 domain), keys >= sk set to -inf.
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[kBlockN / 8][4],
                                            const uint32_t (&qf)[kContraction<D> / 16][4],
                                            const bf16* sK, int n0, int sk, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
    const bf16* krow = sK + (nb * 8 + g) * kPitch<D> + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kContraction<D> / 16; ++kk) {
      mma_bf16_16816(s[nb], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (n0 + nb * 8 + 2 * t + (i & 1) >= sk) s[nb][i] = -INFINITY;
    }
  }
}

// acc += branch_scale * softmax(s) V over keys [0, sk) of one head (rows g
// and g + 8 of this warp's 16), in two passes as the header says. sk > 0.
template <int D>
__device__ __forceinline__ void add_branch(float (&acc)[D / 8][4],
                                           const uint32_t (&qf)[kContraction<D> / 16][4],
                                           const bf16* kh, int64_t k_row, const bf16* vh,
                                           int64_t v_row, int sk, float branch_scale, bf16* sK,
                                           bf16* sVt, int g, int t) {
  float s[kBlockN / 8][4];
  // ---- pass 1: row max and sum (every tile holds a valid key, key n0) ----
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int n0 = 0; n0 < sk; n0 += kBlockN) {
    load_tile<D>(sK, kh, k_row, n0, sk);
    __syncthreads();
    tile_scores<D>(s, qf, sK, n0, sk, g, t);
    __syncthreads();  // before the next tile overwrites sK
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) tile_max[i >> 1] = fmaxf(tile_max[i >> 1], s[nb][i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a group hold the same row
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r]);  // finite: the tile has a valid key
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < kBlockN / 8; ++nb) {
        sum += exp2f(s[nb][2 * r] - m_new) + exp2f(s[nb][2 * r + 1] - m_new);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * exp2f(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }
  // l >= 1: the row max contributes exp2(0)
  const float w[2] = {branch_scale / l[0], branch_scale / l[1]};

  // ---- pass 2: P = exp2(s - m) * w, acc += P V ----
  for (int n0 = 0; n0 < sk; n0 += kBlockN) {
    load_tile<D>(sK, kh, k_row, n0, sk);
    load_tile_t<D>(sVt, vh, v_row, n0, sk);
    __syncthreads();
    tile_scores<D>(s, qf, sK, n0, sk, g, t);
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = exp2f(s[nb][i] - m[i >> 1]) * w[i >> 1];
    mma_cols<D>(acc, s, sVt, g, t);
    __syncthreads();  // before the next tile overwrites sK / sVt
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
cross_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ k_ip,
                  const bf16* __restrict__ v_ip, bf16* __restrict__ o, int sq, int sk,
                  int sk_ip, Strides qs, Strides ks, Strides vs, Strides kis, Strides vis,
                  Strides os, float scale_log2, float ip_scale) {
  constexpr int kDK = kContraction<D>;
  // sK holds Q first, then each K tile: 44.5 KB with sVt at D=160, under the
  // 48 KB a kernel may declare statically.
  __shared__ __align__(16) bf16 sK[kBlockN * kPitch<D>];
  __shared__ __align__(16) bf16 sVt[D * (kBlockN + kPad)];

  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // mma group: row within the 8-row slab
  const int t = lane % 4;   // thread in group: column pair

  // ---- Q fragments (A operand), pre-scaled by scale*log2(e) ----
  load_tile<D>(sK, q + b * qs.batch + h * qs.head, qs.row, m0, sq, scale_log2);
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

  add_branch<D>(acc, qf, k + b * ks.batch + h * ks.head, ks.row, v + b * vs.batch + h * vs.head,
                vs.row, sk, 1.f, sK, sVt, g, t);
  if (sk_ip > 0) {
    add_branch<D>(acc, qf, k_ip + b * kis.batch + h * kis.head, kis.row,
                  v_ip + b * vis.batch + h * vis.head, vis.row, sk_ip, ip_scale, sK, sVt, g, t);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(o, os, acc, one, b, h, sq, m0 + warp * 16, g, t);
}

struct Args {
  const void *q, *k, *v, *k_ip, *v_ip;
  void* o;
  int batch, sq, sk, sk_ip, heads;
  Strides qs, ks, vs, kis, vis, os;
  float scale_log2, ip_scale;
  cudaStream_t stream;
};

template <int D>
void launch(const Args& a) {
  dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.heads, a.batch);
  cross_attn_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.k_ip),
      static_cast<const bf16*>(a.v_ip), static_cast<bf16*>(a.o), a.sq, a.sk, a.sk_ip, a.qs,
      a.ks, a.vs, a.kis, a.vis, a.os, a.scale_log2, a.ip_scale);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Strides are in elements, three
// per operand (batch, head, row); unit stride along D. k_ip and v_ip are
// null with sk_ip = 0 for the text branch alone. Returns
// cudaGetLastError() after the launch (0 on success); an unsupported
// head_dim or an empty or inconsistent shape returns cudaErrorInvalidValue
// without launching.
extern "C" int cross_attn_nhd_bf16(
    const void* q, const void* k, const void* v, const void* k_ip, const void* v_ip, void* o,
    int batch, int sq, int sk, int sk_ip, int heads, int head_dim,
    long long q_batch, long long q_head, long long q_row,
    long long k_batch, long long k_head, long long k_row,
    long long v_batch, long long v_head, long long v_row,
    long long kip_batch, long long kip_head, long long kip_row,
    long long vip_batch, long long vip_head, long long vip_row,
    long long o_batch, long long o_head, long long o_row,
    float scale_log2, float ip_scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535 ||
      sk_ip < 0 || (sk_ip > 0) != (k_ip != nullptr && v_ip != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, k_ip, v_ip, o, batch, sq, sk, sk_ip, heads,
               {q_batch, q_head, q_row}, {k_batch, k_head, k_row}, {v_batch, v_head, v_row},
               {kip_batch, kip_head, kip_row}, {vip_batch, vip_head, vip_row},
               {o_batch, o_head, o_row}, scale_log2, ip_scale,
               static_cast<cudaStream_t>(stream)};
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

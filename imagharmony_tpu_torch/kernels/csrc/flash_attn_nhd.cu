// K1 and K4: fused self-attention, bf16 in and out, one device kernel
// (`attn_fwd_wgmma_kernel`, written for Hopper, sm_90a) under two entry
// points that differ only in the strides they hand it:
//
//   * K1, `flash_attn_nhd_bf16`: the packed (B, S, H*D) layout, head h at
//     column h*D, q/k/v as column views of one to_qkv output. Replaces the
//     TPU kernel `_attn_nhd_kernel` (imagharmony_tpu/kernels/
//     flash_attention.py:415), reached through `flash_attention_nhd` (:576).
//     Head dims 32, 64, 128.
//   * K4, `flash_attn_bhsd_bf16`: the head-split (B, H, S, D) layout with a
//     batch, head and row stride for q, k, v and the output. Replaces the TPU
//     kernel `_attn_kernel` (:95), reached through `flash_attention` (:369) ->
//     `_flash_fwd_impl` (:138). Head dims 32, 40, 64, 80, 128, 160.
//
// Both compute the exact softmax, unlike the Pallas kernels: a running row
// max and sum (online softmax), no clamp on the exp2 argument, and no padding
// of the sequence on the host (ragged key columns and query rows are masked
// here). Q is pre-scaled by scale*log2(e) and rounded to bf16 as the Pallas
// kernel does (:428), P is rounded to bf16 before PV, and optionally (lse !=
// nullptr) the row log-sum-exp in that scaled-log2 domain, lse = m + log2(l)
// with m the row max of s = q.k*scale*log2(e) and l = sum exp2(s - m), fp32
// (B, H, Sq), is written for the backward (K3, flash_attn_nhd_bwd.cu) to
// recompute P = exp2(s - lse). A null pointer writes nothing.
//
// What bounds them on an H100: at head_dim 64 the work is 4*B*H*Sq*Sk*D
// flops against (3+1)*B*S*H*D*2 bytes, e.g. S=4096, H=10, B=2: 86 GFLOP
// against 42 MB, about 2000 flop/byte, far above the card's ~295 flop/byte
// ridge; K4 at d=40, S=4096, H=8, B=2: 43 GFLOP against 21 MB. So they are
// bound by the tensor cores, and the kernel keeps the (Sq, Sk) logits out of
// device memory: they live in registers, one key tile at a time.
//
// The design, for the tensor cores' wgmma rate:
//   * one CTA per 64 * NWG query rows of one head: NWG consumer warpgroups
//     of 64 rows each and one producer warp. NWG = 2 where that still gives
//     a full wave of CTAs (SDXL's 1024² shapes, SD1.5's (2, 4096, 8, 40)),
//     else 1 (training's batch 1: (1, 256, 20, 64) is 80 CTAs of 64 rows,
//     40 of 128), and always 1 at D = 160, where the third O panel would
//     not fit in the 168 registers a 288-thread block allows.
//   * the producer warp brings Q once and then every K and V tile with TMA
//     (sm90_tiles.cuh) into a ring of kFwdStages stages, each with a "full"
//     mbarrier (the copies' bytes) and an "empty" one (every consumer thread
//     arrives when its products are done with the stage), so the next
//     tiles' copies overlap this tile's math. The tensor maps are 4-D over
//     (d, h, s, b) or (d, s, h, b), ordered by stride, with each operand's
//     own strides: column views of to_qkv and head-split views go in as they
//     are, and rows past S come in as zeros (keys past Sk are then masked to
//     -inf here: a zero key would score 0, not -inf).
//   * each consumer warpgroup scales its 64 Q rows in shared memory once,
//     then per key tile: S = Q K^T by wgmma (both K-major from shared
//     memory), the online-softmax update in registers, and O += P V by wgmma
//     with P from registers (the accumulator layout is the A-fragment
//     layout) and V read MN-major from the same tile: no transposed copy.
//   * BN keys per tile: 128 at D <= 64, 64 above (registers: the S
//     accumulator is BN/2 a thread, O 32 per 64-column panel).
//   * a head of D columns is ceil(D/64) panels of 64: QK^T stops at
//     ceil(D/16) steps of 16, but PV runs over whole panels, so at D = 40
//     and 80 a third of PV's columns are the zeros TMA fills in past D.
//   * the output goes back through the Q tile in shared memory and TMA
//     stores, which leave out the rows past Sq and the columns past D.

#include "sm90_tiles.cuh"

namespace {

using sm90::kPanelCols;
using sm90::kRowBytes;

constexpr int kFwdStages = 2;

struct FwdMaps {
  sm90::Map q, k, v, o;
};

struct FwdArgs {
  float* lse;  // null, or fp32 (B, H, Sq)
  int sq, sk, heads;
  float scale_log2;
};

// Keys per tile at head dim D.
template <int D>
constexpr int kFwdKeys = D <= 64 ? 128 : 64;

// Shared memory of one CTA, in bytes from a 1024-aligned base: the Q tile
// (NWG * 64 rows), then kFwdStages stages of a K and a V tile (BN rows),
// then the barriers. Every tile is kPanels<D> panels.
template <int D, int NWG>
struct FwdSmem {
  static constexpr int kQPanel = NWG * 64 * kRowBytes;
  static constexpr int kKVPanel = kFwdKeys<D> * kRowBytes;
  static constexpr int kQ = sm90::kPanels<D> * kQPanel;
  static constexpr int kKV = sm90::kPanels<D> * kKVPanel;
  static constexpr int kBars = kQ + 2 * kFwdStages * kKV;
  static constexpr int kBytes = kBars + (2 * kFwdStages + 1) * 8 + sm90::kSmemAlign;
};

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs a) {
  using L = FwdSmem<D, NWG>;
  constexpr int kP = sm90::kPanels<D>;
  constexpr int BN = kFwdKeys<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (sm90::kSmemAlign - sm90::smem_u32(smem_raw) % sm90::kSmemAlign) %
                                 sm90::kSmemAlign;
  uint8_t* sQ = smem;
  uint8_t* sKV = smem + L::kQ;  // stage s: K at sKV + 2 s kKV, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kFwdStages;
  uint64_t* qbar = empty + kFwdStages;

  const int m0 = blockIdx.x * NWG * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (a.sk + BN - 1) / BN;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NWG * 128);
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // ---- producer: Q once, then the K and V tiles through the ring ----
    if (threadIdx.x % 32 == 0) {
      sm90::mbar_expect_tx(qbar, L::kQ);
      for (int p = 0; p < kP; ++p) {
        sm90::tma_load(sQ + p * L::kQPanel, maps.q, qbar, p * kPanelCols, h, m0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kFwdStages;
        if (j >= kFwdStages) sm90::mbar_wait(&empty[s], (j / kFwdStages - 1) & 1);
        uint8_t* sK = sKV + 2 * s * L::kKV;
        uint8_t* sV = sK + L::kKV;
        sm90::mbar_expect_tx(&full[s], 2 * L::kKV);
        for (int p = 0; p < kP; ++p) {
          sm90::tma_load(sK + p * L::kKVPanel, maps.k, &full[s], p * kPanelCols, h, j * BN, b);
          sm90::tma_load(sV + p * L::kKVPanel, maps.v, &full[s], p * kPanelCols, h, j * BN, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows m0 + 64 wg .. + 63 ----
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;

  // scale this warpgroup's Q rows by scale*log2(e), rounded to bf16
  sm90::mbar_wait(qbar, 0);
  constexpr int kChunks = kP * kPanelCols / 8;  // 16-byte chunks a row
  for (int i = tid; i < 64 * kChunks; i += 128) {
    const int row = 64 * wg + i / kChunks;
    const int col = (i % kChunks) * 8;
    uint4* ptr = reinterpret_cast<uint4*>(sQ + (col / kPanelCols) * L::kQPanel +
                                          sm90::swz(row, col % kPanelCols));
    uint4 val = *ptr;
    uint32_t* w = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
      w[e] = sm90::pack_bf16x2(__low2float(x) * a.scale_log2, __high2float(x) * a.scale_log2);
    }
    *ptr = val;
  }
  sm90::fence_async_shared();
  sm90::named_bar(1 + wg, 128);

  const uint8_t* q_rows = sQ + wg * 64 * kRowBytes;
  float o[kP][32];
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[p][e] = 0.f;
  // rows g and g + 8 of this thread's warp slice: running max and this
  // thread's part of the running sum (its quad's four parts add up at the end)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kFwdStages;
    sm90::mbar_wait(&full[s], (j / kFwdStages) & 1);
    const uint8_t* sK = sKV + 2 * s * L::kKV;
    const uint8_t* sV = sK + L::kKV;

    // ---- S = Q K^T, log2 domain: BN/64 accumulators of 64 keys ----
    float sc[BN / 64][32];
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
#pragma unroll
      for (int k = 0; k < sm90::kSteps<D>; ++k) {
        const int off = (k % 4) * 32;
        sm90::wgmma_ss(sc[c], sm90::desc_k(q_rows + (k / 4) * L::kQPanel + off),
                       sm90::desc_k(sK + (k / 4) * L::kKVPanel + c * 64 * kRowBytes + off),
                       k > 0);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) sm90::fence_regs(sc[c]);

    // ---- mask keys past Sk (the last tile only), online softmax ----
    if ((j + 1) * BN > a.sk) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = j * BN + c * 64 + 8 * (e / 4) + 2 * t + (e & 1);
          if (key >= a.sk) sc[c][e] = -INFINITY;
        }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[c][e]);
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the quad's four threads hold the same row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no key yet keeps max -inf: base 0 gives exp2(-inf) = 0, no NaN
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float pr = exp2f(sc[c][e] - base[(e >> 1) & 1]);
        sc[c][e] = pr;
        l_run[(e >> 1) & 1] += pr;
      }
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[p][e] *= alpha[(e >> 1) & 1];

    // ---- O += P V: P from registers, V MN-major from the tile ----
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int k = 0; k < BN / 16; ++k) sm90::pack_a(pa[k], sc[k / 4], k % 4);
    sm90::wgmma_fence();
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) {
        sm90::wgmma_rs(o[p], pa[k], sm90::desc_mn(sV + p * L::kKVPanel + k * 16 * kRowBytes));
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int p = 0; p < kP; ++p) sm90::fence_regs(o[p]);
    sm90::mbar_arrive(&empty[s]);
  }

  // ---- lse, normalise, store through this warpgroup's Q rows ----
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    const int row = m0 + 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * r;
    if (a.lse != nullptr && t == 0 && row < a.sq) {
      a.lse[((int64_t)b * a.heads + h) * a.sq + row] = m_run[r] + log2f(l_run[r]);
    }
  }
  sm90::named_bar(1 + wg, 128);  // every warp's last product has read the Q rows
#pragma unroll
  for (int p = 0; p < kP; ++p) sm90::store_acc(sQ + p * L::kQPanel, o[p], 64 * wg, inv);
  sm90::fence_async_shared();
  sm90::named_bar(1 + wg, 128);
  if (tid == 0) {
    for (int p = 0; p < kP; ++p) {
      sm90::tma_store(maps.o, sQ + p * L::kQPanel + wg * 64 * kRowBytes, p * kPanelCols, h,
                      m0 + 64 * wg, b);
    }
    sm90::tma_store_wait();
  }
}

// Element strides of one operand: between batches, heads and rows.
struct Strides {
  long long batch, head, row;
};

template <int D, int NWG>
int launch_fwd(const void* q, const void* k, const void* v, void* o, const Strides& qs,
               const Strides& ks, const Strides& vs, const Strides& os, const FwdArgs& a,
               int batch, cudaStream_t stream) {
  using L = FwdSmem<D, NWG>;
  FwdMaps maps;
  if (!sm90::make_map(&maps.q, q, D, a.heads, a.sq, batch, qs.batch, qs.head, qs.row, NWG * 64) ||
      !sm90::make_map(&maps.k, k, D, a.heads, a.sk, batch, ks.batch, ks.head, ks.row,
                      kFwdKeys<D>) ||
      !sm90::make_map(&maps.v, v, D, a.heads, a.sk, batch, vs.batch, vs.head, vs.row,
                      kFwdKeys<D>) ||
      !sm90::make_map(&maps.o, o, D, a.heads, a.sq, batch, os.batch, os.head, os.row, 64)) {
    return (int)cudaErrorInvalidPitchValue;
  }
  static sm90::PerDevice smem_set;
  const cudaError_t err = sm90::allow_smem(
      reinterpret_cast<const void*>(attn_fwd_wgmma_kernel<D, NWG>), L::kBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + NWG * 64 - 1) / (NWG * 64), a.heads, batch);
  attn_fwd_wgmma_kernel<D, NWG><<<grid, NWG * 128 + 32, L::kBytes, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

// The launch both entry points share: NWG by the grid the shape gives, the
// head dim checked against what the entry point takes (K1's three or K4's
// six).
int fwd(const void* q, const void* k, const void* v, void* o, const Strides& qs,
        const Strides& ks, const Strides& vs, const Strides& os, float* lse, int batch, int sq,
        int sk, int heads, int head_dim, bool bhsd_dims, float scale_log2, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const FwdArgs a{lse, sq, sk, heads, scale_log2};
  // two warpgroups a CTA where that still fills the card with CTAs
  const bool wide = (long long)((sq + 127) / 128) * heads * batch >= sm90::sm_count();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_LAUNCH(D)                                                                      \
  return wide ? launch_fwd<D, 2>(q, k, v, o, qs, ks, vs, os, a, batch, st)                 \
              : launch_fwd<D, 1>(q, k, v, o, qs, ks, vs, os, a, batch, st)
  switch (head_dim) {
    case 32: FWD_LAUNCH(32);
    case 64: FWD_LAUNCH(64);
    case 128: FWD_LAUNCH(128);
    case 40: if (bhsd_dims) FWD_LAUNCH(40); break;
    case 80: if (bhsd_dims) FWD_LAUNCH(80); break;
    case 160:
      if (bhsd_dims) return launch_fwd<160, 1>(q, k, v, o, qs, ks, vs, os, a, batch, st);
      break;
    default: break;
  }
#undef FWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Strides are in elements. Every
// base address and stride must be a multiple of 16 bytes (the TMA's rule):
// an operand whose tensor map cuTensorMapEncodeTiled refuses returns
// cudaErrorInvalidPitchValue, an unsupported head_dim or an empty shape
// cudaErrorInvalidValue, both without launching. Else the launch's
// cudaGetLastError() (0 on success).

// K1: packed (B, S, H*D) q, k, v with a row and a batch stride each (head h
// at column h*D); o is a contiguous (B, Sq, H*D) buffer; lse is null or a
// contiguous fp32 (B, H, Sq) buffer. head_dim 32, 64 or 128.
extern "C" int flash_attn_nhd_bf16(const void* q, const void* k, const void* v, void* o,
                                   float* lse,
                                   int batch, int sq, int sk, int heads, int head_dim,
                                   long long q_row, long long k_row, long long v_row,
                                   long long q_batch, long long k_batch,
                                   long long v_batch, float scale_log2, void* stream) {
  const long long hd = (long long)heads * head_dim;
  return fwd(q, k, v, o, {q_batch, head_dim, q_row}, {k_batch, head_dim, k_row},
             {v_batch, head_dim, v_row}, {sq * hd, head_dim, hd}, lse, batch, sq, sk, heads,
             head_dim, false, scale_log2, stream);
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
  return fwd(q, k, v, o, {q_batch, q_head, q_row}, {k_batch, k_head, k_row},
             {v_batch, v_head, v_row}, {o_batch, o_head, o_row}, lse, batch, sq, sk, heads,
             head_dim, true, scale_log2, stream);
}

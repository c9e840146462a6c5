// K3: backward of K1 and K4 (fused self-attention), bf16 in and out, fp32
// accumulation, written for Hopper (sm_90a) on the helpers of sm90_tiles.cuh.
// Two entry points that differ only in the strides they hand the same
// kernels:
//
//   * `flash_attn_nhd_bwd_bf16`: K1's packed (B, S, H*D) layout, head h at
//     column h*D; dq, dk, dv contiguous (B, S, H*D).
//   * `flash_attn_bhsd_bwd_bf16`: K4's head-split (B, H, S, D) layout with a
//     batch, a head and a row stride for every operand and output, so
//     `split_heads` views of a packed to_qkv output go in with no copy.
//
// Head dims 32, 40, 64, 80, 128, 160 under both.
//
// Replaces the TPU kernel `_attn_bwd_kernel` (imagharmony_tpu/kernels/
// flash_attention.py:220), reached through `_flash_bwd_impl` (:270) from the
// custom_vjp backwards `_flash_nhd_bwd` (:540, K1's) and `_flash_bwd` (:350,
// K4's). The Pallas kernel relayouts to (B, H, S, D), pads d to 64 in device
// memory and recomputes a no-max softmax clamped at exp(80); this one takes
// the operands where they lie and recomputes the exact softmax from the row
// log-sum-exp the forward writes (`lse`, scaled-log2 domain: lse = m +
// log2(l) with m the row max of s = q.k*scale*log2(e) and l = sum
// exp2(s - m)), so P = exp2(s - lse) needs no running max here.
//
//   dV = P^T dO        dS = P o (dO V^T - Delta),  Delta = rowsum(dO o O)
//   dQ = scale dS K    dK = scale dS^T Q
//
// What bounds it on an H100: 5 products of (Sq, Sk, D), 10*B*H*Sq*Sk*D flops,
// against q, k, v, o, dO read once and dq, dk, dv written once. At the
// training shape S=1024, H=10, D=64 that is 6.7 GFLOP against 16 MB, about
// 400 flop/byte, above the ~295 flop/byte ridge: tensor-core bound. So, as in
// K1, the (Sq, Sk) probabilities never reach device memory.
//
// Design: three kernels, no atomics, so two calls on the same inputs give
// bit-identical gradients.
//   1. attn_bwd_prep_kernel, 4-32 lanes per (row, head): Delta in fp32;
//      Qs = bf16(q * scale*log2(e)), rounded exactly as the forward rounds
//      it, so P here is the forward's P; and lse and Delta padded to a
//      multiple of 64 rows (+inf and 0 past Sq, so P = 0 and dS = 0 there).
//      All three go to the caller's scratch (see the entry points).
//   2. attn_bwd_dkdv_kernel, one CTA per (64-key tile, head, batch): its K
//      and V come in once by TMA and stay in shared memory; Qs, Q, dO (TMA)
//      and the tile's lse and Delta (bulk copies) of every 64-row query tile
//      stream through a ring of kStages stages, so the next query tiles'
//      copies overlap this one's math. Per query tile, by wgmma:
//      S^T = K Qs^T and dP^T = V dO^T with every operand K-major in shared
//      memory; P^T = exp2(S^T - lse) and dS^T = P^T o (dP^T - Delta) in
//      registers; dV += P^T dO and dK += dS^T Q with P^T and dS^T from
//      registers and dO and Q read MN-major from the same tiles, so nothing
//      is staged transposed. Up to D=64 one warpgroup holds dV and dK
//      (4 x 32 accumulator registers a thread); above, two warpgroups share
//      the key tile, one holding dV and one dK (up to 96 registers each at
//      D=160), each computing the S^T it needs in the same pass over the
//      query tiles: no second pass. There is no producer warp: thread 0
//      issues the copies, the first kStages tiles up front and each later
//      one as soon as every consumer has released its stage. A separate
//      producer would make a third, partial warpgroup, and ptxas then caps a
//      thread at 168 registers (65536 / 384), below what the dK warpgroup
//      holds at D=160 (setmaxnreg did not lift the cap); 256 threads get up
//      to 255, so nothing spills.
//   3. attn_bwd_dq_kernel, one CTA per (64-row query tile, head, batch): Qs
//      and dO once, K and V of every key tile through the ring; S = Qs K^T,
//      dP = dO V^T, dS, dQ += dS K (K read MN-major). It recomputes S and dP:
//      7 products of (Sq, Sk, D) in all, where one kernel with an ordered
//      reduction of dQ across key tiles would need 5.
// Results leave through shared memory and TMA stores, which leave out the
// rows past S and the columns past D. A head of D columns is D/64 panels of
// 64 (sm90_tiles.cuh): products over D take ceil(D/16) steps of 16 and the
// zero columns TMA fills in past D are never read; products whose N is D run
// over whole panels (at D = 40, 80 and 160 that is 64, 128 and 192 columns,
// the columns past D zero and never stored).
// Keys past Sk come in as zero rows: their dK and dV rows are not stored and
// their contribution to dQ is dS * 0 = 0, so nothing is masked.

#include <math.h>

#include "sm90_tiles.cuh"

namespace {

using sm90::kPanelCols;
using sm90::kRowBytes;

constexpr int kRows = 64;   // rows of every tile: keys or queries
constexpr int kStages = 2;  // ring depth of both loops

// Element strides of one operand: between batches, heads and rows.
struct Strides {
  int64_t batch, head, row;
};

// Rows of the padded lse and Delta: Sq rounded up to the tile.
inline int padded(int sq) { return (sq + kRows - 1) / kRows * kRows; }

// ---- 1. prep ---------------------------------------------------------------------

struct PrepArgs {
  const sm90::bf16* q;
  const sm90::bf16* o;
  const sm90::bf16* dout;
  const float* lse;  // (B, H, Sq)
  float* lse_pad;    // (B, H, Sq_pad)
  float* delta_pad;  // (B, H, Sq_pad)
  sm90::bf16* qs;    // (B, Sq, H, D)
  int sq, sq_pad, heads;
  Strides qst, ost, dost;
  float scale_log2;
  int64_t total;  // B * Sq_pad * H (row, head) pairs, kPrepLanes<D> lanes each
};

// Lanes a (row, head) pair takes in the prep kernel: its D/8 16-byte
// chunks rounded up to a power of two, so a warp serves 32/G pairs and
// every load of a row goes out at once.
template <int D>
constexpr int kPrepLanes = D <= 32 ? 4 : D <= 64 ? 8 : D <= 128 ? 16 : 32;

template <int D>
__global__ void __launch_bounds__(256) attn_bwd_prep_kernel(const PrepArgs a) {
  constexpr int kChunks = D / 8;
  constexpr int G = kPrepLanes<D>;
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  // no thread returns before the shuffles below: they take the whole warp
  const bool live = i < a.total;
  const int h = (int)(i % a.heads);
  const int64_t rest = i / a.heads;
  const int row = (int)(rest % a.sq_pad);
  const int b = (int)(rest / a.sq_pad);
  const bool in_seq = live && row < a.sq;
  float acc = 0.f;
  if (in_seq && lane < kChunks) {
    const int c = lane * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(
        a.o + b * a.ost.batch + h * a.ost.head + row * a.ost.row + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        a.dout + b * a.dost.batch + h * a.dost.head + row * a.dost.row + c);
    uint4 qv = *reinterpret_cast<const uint4*>(
        a.q + b * a.qst.batch + h * a.qst.head + row * a.qst.row + c);
    const sm90::bf16* eo = reinterpret_cast<const sm90::bf16*>(&ov);
    const sm90::bf16* ed = reinterpret_cast<const sm90::bf16*>(&dv);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += __bfloat162float(eo[j]) * __bfloat162float(ed[j]);
    uint32_t* w = reinterpret_cast<uint32_t*>(&qv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
      w[e] = sm90::pack_bf16x2(__low2float(x) * a.scale_log2, __high2float(x) * a.scale_log2);
    }
    *reinterpret_cast<uint4*>(a.qs + (((int64_t)b * a.sq + row) * a.heads + h) * D + c) = qv;
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && lane == 0) {
    const int64_t stat = ((int64_t)b * a.heads + h) * a.sq_pad + row;
    a.lse_pad[stat] = in_seq ? a.lse[((int64_t)b * a.heads + h) * a.sq + row] : INFINITY;
    a.delta_pad[stat] = acc;  // 0 past Sq
  }
}

// ---- 2. and 3.: the wgmma kernels ----------------------------------------------

struct BwdMaps {
  sm90::Map qs, q, k, v, dout, dq, dk, dv;  // boxes of 64 rows
};

struct BwdArgs {
  const float* lse_pad;    // (B, H, Sq_pad)
  const float* delta_pad;  // (B, H, Sq_pad)
  int sq, sk, sq_pad, heads;
  float scale;
};

// Bytes of a 64-row tile of one head, and of a panel of it.
template <int D>
constexpr int kTile = sm90::kPanels<D> * kRows * kRowBytes;
constexpr int kPanel = kRows * kRowBytes;

// Warpgroups of a dK/dV CTA: one up to D=64, one for dV and one for dK above.
template <int D>
constexpr int kDkdvGroups = D <= 64 ? 1 : 2;


// The dK/dV CTA's shared memory from a 1024-aligned base: K, V, then
// kStages stages of [Qs, Q, dO, lse (64 floats), Delta (64 floats), padding
// to 1024], then the barriers.
template <int D>
struct DkdvSmem {
  static constexpr int kStats = 3 * kTile<D>;
  static constexpr int kStage = 3 * kTile<D> + 1024;
  static constexpr int kBars = 2 * kTile<D> + kStages * kStage;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + sm90::kSmemAlign;
};

// The dQ CTA's: Qs, dO, then kStages stages of [K, V], then the barriers.
template <int D>
struct DqSmem {
  static constexpr int kStage = 2 * kTile<D>;
  static constexpr int kBars = 2 * kTile<D> + kStages * kStage;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + sm90::kSmemAlign;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + (sm90::kSmemAlign - sm90::smem_u32(raw) % sm90::kSmemAlign) % sm90::kSmemAlign;
}

// acc (64 x 64) = A . B^T over D columns, A and B two 64-row tiles of one
// head, both K-major.
template <int D>
__device__ __forceinline__ void product_kk(float (&acc)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int k = 0; k < sm90::kSteps<D>; ++k) {
    const int off = (k / 4) * kPanel + (k % 4) * 32;
    sm90::wgmma_ss(acc, sm90::desc_k(a + off), sm90::desc_k(b + off), k > 0);
  }
}

// acc[p] (64 x 64 columns of panel p) += X . B over 64 rows, X (64 x 64) in
// registers as four A fragments, B a 64-row tile read MN-major.
template <int D>
__device__ __forceinline__ void product_rm(float (&acc)[sm90::kPanels<D>][32],
                                           const uint32_t (&x)[4][4], const uint8_t* b) {
#pragma unroll
  for (int p = 0; p < sm90::kPanels<D>; ++p)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sm90::wgmma_rs(acc[p], x[k], sm90::desc_mn(b + p * kPanel + k * 16 * kRowBytes));
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][32]) {
#pragma unroll
  for (int p = 0; p < N; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
}

// The copies of query tile j into its stage of a dK/dV CTA: Qs, Q and dO
// by TMA, the tile's lse and Delta by bulk copies, all completing on the
// stage's full barrier. One thread runs it.
template <int D>
__device__ __forceinline__ void load_query_tile(const BwdMaps& maps, const BwdArgs& a,
                                                uint8_t* stages, uint64_t* full, int j, int h,
                                                int b) {
  using L = DkdvSmem<D>;
  const int s = j % kStages;
  uint8_t* st = stages + s * L::kStage;
  const int64_t stat = ((int64_t)b * a.heads + h) * a.sq_pad + j * kRows;
  sm90::mbar_expect_tx(&full[s], 3 * kTile<D> + 2 * kRows * 4);
  for (int p = 0; p < sm90::kPanels<D>; ++p) {
    const int col = p * kPanelCols;
    sm90::tma_load(st + p * kPanel, maps.qs, &full[s], col, h, j * kRows, b);
    sm90::tma_load(st + kTile<D> + p * kPanel, maps.q, &full[s], col, h, j * kRows, b);
    sm90::tma_load(st + 2 * kTile<D> + p * kPanel, maps.dout, &full[s], col, h, j * kRows, b);
  }
  sm90::bulk_load(st + L::kStats, a.lse_pad + stat, kRows * 4, &full[s]);
  sm90::bulk_load(st + L::kStats + kRows * 4, a.delta_pad + stat, kRows * 4, &full[s]);
}

// One consumer warpgroup of a dK/dV CTA over every query tile: dV if kDV,
// dK if kDK. With two warpgroups both read the stage, so the empty barrier
// counts both. Thread 0 refills each stage once every consumer has
// released it.
template <int D, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_consumer(const BwdMaps& maps, const BwdArgs& a,
                                              uint8_t* sK, uint8_t* sV, uint8_t* stages,
                                              uint64_t* full, uint64_t* empty, int n0, int h,
                                              int b, int n_tiles, int wg) {
  using L = DkdvSmem<D>;
  constexpr int kP = sm90::kPanels<D>;
  constexpr int kGroups = kDkdvGroups<D>;
  const int t = threadIdx.x % 4;
  float dv[kDV ? kP : 1][32], dk[kDK ? kP : 1][32];
  zero(dv);
  zero(dk);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&full[s], (j / kStages) & 1);
    const uint8_t* sQs = stages + s * L::kStage;
    const uint8_t* sQ = sQs + kTile<D>;
    const uint8_t* sdO = sQ + kTile<D>;
    const float* s_lse = reinterpret_cast<const float*>(sQs + L::kStats);
    const float* s_delta = s_lse + kRows;

    // S^T (keys x queries, log2 domain) and dP^T
    float st[32], dpt[kDK ? 32 : 1];
    sm90::wgmma_fence();
    product_kk<D>(st, sK, sQs);
    if constexpr (kDK) product_kk<D>(dpt, sV, sdO);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(st);
    if constexpr (kDK) sm90::fence_regs(dpt);

    // P^T = exp2(S^T - lse), dS^T = P^T o (dP^T - Delta); column = query
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e / 4) + 2 * t + (e & 1);
      const float p = exp2f(st[e] - s_lse[col]);
      st[e] = p;
      if constexpr (kDK) dpt[e] = p * (dpt[e] - s_delta[col]);
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kDV) sm90::pack_a(pa[k], st, k);
      if constexpr (kDK) sm90::pack_a(da[k], dpt, k);
    }
    sm90::wgmma_fence();
    if constexpr (kDV) product_rm<D>(dv, pa, sdO);  // dV += P^T dO
    if constexpr (kDK) product_rm<D>(dk, da, sQ);   // dK += dS^T Q
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if constexpr (kDV) sm90::fence_regs(dv[p]);
      if constexpr (kDK) sm90::fence_regs(dk[p]);
    }
    sm90::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && j + kStages < n_tiles) {
      sm90::mbar_wait(&empty[s], (j / kStages) & 1);
      load_query_tile<D>(maps, a, stages, full, j + kStages, h, b);
    }
  }

  // every warp of every warpgroup is done with K and V: they take dK and dV
  sm90::named_bar(1, kGroups * 128);
  const float one[2] = {1.f, 1.f};
  const float scale[2] = {a.scale, a.scale};
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    if constexpr (kDV) sm90::store_acc(sV + p * kPanel, dv[p], 0, one);
    if constexpr (kDK) sm90::store_acc(sK + p * kPanel, dk[p], 0, scale);
  }
  sm90::fence_async_shared();
  sm90::named_bar(2 + wg, 128);
  if (threadIdx.x % 128 == 0) {
    for (int p = 0; p < kP; ++p) {
      if constexpr (kDV) sm90::tma_store(maps.dv, sV + p * kPanel, p * kPanelCols, h, n0, b);
      if constexpr (kDK) sm90::tma_store(maps.dk, sK + p * kPanel, p * kPanelCols, h, n0, b);
    }
    sm90::tma_store_wait();
  }
}

template <int D>
__global__ void __launch_bounds__(kDkdvGroups<D> * 128, 1)
attn_bwd_dkdv_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using L = DkdvSmem<D>;
  constexpr int kP = sm90::kPanels<D>;
  constexpr int kGroups = kDkdvGroups<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = aligned_smem(smem_raw);
  uint8_t* sV = sK + kTile<D>;
  uint8_t* stages = sV + kTile<D>;
  uint64_t* full = reinterpret_cast<uint64_t*>(sK + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int n0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (a.sq + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kGroups * 128);
    }
    sm90::mbar_init(kvbar, 1);
    sm90::fence_barrier_init();
    // K and V once, then the first query tiles; the rest follow in the loop
    sm90::mbar_expect_tx(kvbar, 2 * kTile<D>);
    for (int p = 0; p < kP; ++p) {
      sm90::tma_load(sK + p * kPanel, maps.k, kvbar, p * kPanelCols, h, n0, b);
      sm90::tma_load(sV + p * kPanel, maps.v, kvbar, p * kPanelCols, h, n0, b);
    }
    for (int j = 0; j < kStages && j < n_tiles; ++j) {
      load_query_tile<D>(maps, a, stages, full, j, h, b);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  sm90::mbar_wait(kvbar, 0);
  if constexpr (kGroups == 1) {
    dkdv_consumer<D, true, true>(maps, a, sK, sV, stages, full, empty, n0, h, b, n_tiles, wg);
  } else if (wg == 0) {
    dkdv_consumer<D, true, false>(maps, a, sK, sV, stages, full, empty, n0, h, b, n_tiles, wg);
  } else {
    dkdv_consumer<D, false, true>(maps, a, sK, sV, stages, full, empty, n0, h, b, n_tiles, wg);
  }
}

template <int D>
__global__ void __launch_bounds__(128 + 32, 1)
attn_bwd_dq_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using L = DqSmem<D>;
  constexpr int kP = sm90::kPanels<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQs = aligned_smem(smem_raw);
  uint8_t* sdO = sQs + kTile<D>;
  uint8_t* stages = sdO + kTile<D>;
  uint64_t* full = reinterpret_cast<uint64_t*>(sQs + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int m0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (a.sk + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: Qs and dO once, then every key tile's K and V ----
    if (threadIdx.x % 32 == 0) {
      sm90::mbar_expect_tx(qbar, 2 * kTile<D>);
      for (int p = 0; p < kP; ++p) {
        sm90::tma_load(sQs + p * kPanel, maps.qs, qbar, p * kPanelCols, h, m0, b);
        sm90::tma_load(sdO + p * kPanel, maps.dout, qbar, p * kPanelCols, h, m0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) sm90::mbar_wait(&empty[s], (j / kStages - 1) & 1);
        uint8_t* st = stages + s * L::kStage;
        sm90::mbar_expect_tx(&full[s], 2 * kTile<D>);
        for (int p = 0; p < kP; ++p) {
          const int col = p * kPanelCols;
          sm90::tma_load(st + p * kPanel, maps.k, &full[s], col, h, j * kRows, b);
          sm90::tma_load(st + kTile<D> + p * kPanel, maps.v, &full[s], col, h, j * kRows, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: query rows m0 .. m0 + 63 ----
  const int lane = threadIdx.x % 32;
  const int64_t stat0 = ((int64_t)b * a.heads + h) * a.sq_pad;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + 16 * warp + lane / 4 + 8 * r;  // < Sq_pad
    lse_r[r] = a.lse_pad[stat0 + row];
    delta_r[r] = a.delta_pad[stat0 + row];
  }
  float dq[kP][32];
  zero(dq);
  sm90::mbar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&full[s], (j / kStages) & 1);
    const uint8_t* sK = stages + s * L::kStage;
    const uint8_t* sV = sK + kTile<D>;

    float sc[32], dp[32];
    sm90::wgmma_fence();
    product_kk<D>(sc, sQs, sK);  // S, log2 domain
    product_kk<D>(dp, sdO, sV);  // dP
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      sc[e] = exp2f(sc[e] - lse_r[r]) * (dp[e] - delta_r[r]);  // dS
    }
    uint32_t da[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) sm90::pack_a(da[k], sc, k);
    sm90::wgmma_fence();
    product_rm<D>(dq, da, sK);  // dQ += dS K
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int p = 0; p < kP; ++p) sm90::fence_regs(dq[p]);
    sm90::mbar_arrive(&empty[s]);
  }

  sm90::named_bar(1, 128);  // every warp's last product has read Qs
  const float scale[2] = {a.scale, a.scale};
#pragma unroll
  for (int p = 0; p < kP; ++p) sm90::store_acc(sQs + p * kPanel, dq[p], 0, scale);
  sm90::fence_async_shared();
  sm90::named_bar(1, 128);
  if (threadIdx.x == 0) {
    for (int p = 0; p < kP; ++p) {
      sm90::tma_store(maps.dq, sQs + p * kPanel, p * kPanelCols, h, m0, b);
    }
    sm90::tma_store_wait();
  }
}

// Everything a launch needs beyond the operands: the layouts of q, k, v, o,
// dout and the outputs.
struct Layout {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* scratch;
  void *dq, *dk, *dv;
  int batch, sq, sk, heads;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale, scale_log2;
  cudaStream_t stream;
};

template <int D>
int launch(const Layout& l) {
  const int sq_pad = padded(l.sq);
  float* lse_pad = l.scratch;
  float* delta_pad = lse_pad + (int64_t)l.batch * l.heads * sq_pad;
  sm90::bf16* qs = reinterpret_cast<sm90::bf16*>(delta_pad + (int64_t)l.batch * l.heads * sq_pad);
  const Strides qs_st{(int64_t)l.sq * l.heads * D, D, (int64_t)l.heads * D};

  BwdMaps maps;
  auto map = [&](sm90::Map* m, const void* base, int seq, const Strides& st) {
    return sm90::make_map(m, base, D, l.heads, seq, l.batch, st.batch, st.head, st.row, kRows);
  };
  if (!map(&maps.qs, qs, l.sq, qs_st) || !map(&maps.q, l.q, l.sq, l.qs) ||
      !map(&maps.k, l.k, l.sk, l.ks) || !map(&maps.v, l.v, l.sk, l.vs) ||
      !map(&maps.dout, l.dout, l.sq, l.dos) || !map(&maps.dq, l.dq, l.sq, l.dqs) ||
      !map(&maps.dk, l.dk, l.sk, l.dks) || !map(&maps.dv, l.dv, l.sk, l.dvs)) {
    return (int)cudaErrorInvalidPitchValue;
  }

  const PrepArgs pa{static_cast<const sm90::bf16*>(l.q), static_cast<const sm90::bf16*>(l.o),
                    static_cast<const sm90::bf16*>(l.dout), l.lse, lse_pad, delta_pad, qs,
                    l.sq, sq_pad, l.heads, l.qs, l.os, l.dos, l.scale_log2,
                    (int64_t)l.batch * sq_pad * l.heads};
  const int pairs = 256 / kPrepLanes<D>;  // a block of 256 threads
  attn_bwd_prep_kernel<D><<<(unsigned)((pa.total + pairs - 1) / pairs), 256, 0, l.stream>>>(pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const BwdArgs a{lse_pad, delta_pad, l.sq, l.sk, sq_pad, l.heads, l.scale};
  static sm90::PerDevice dkdv_set, dq_set;  // the attribute, per device
  err = sm90::allow_smem(reinterpret_cast<const void*>(attn_bwd_dkdv_kernel<D>),
                         DkdvSmem<D>::kBytes, dkdv_set);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<D><<<dim3((l.sk + kRows - 1) / kRows, l.heads, l.batch),
                            kDkdvGroups<D> * 128, DkdvSmem<D>::kBytes, l.stream>>>(maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sm90::allow_smem(reinterpret_cast<const void*>(attn_bwd_dq_kernel<D>), DqSmem<D>::kBytes,
                         dq_set);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<D><<<dim3((l.sq + kRows - 1) / kRows, l.heads, l.batch), 128 + 32,
                          DqSmem<D>::kBytes, l.stream>>>(maps, a);
  return (int)cudaGetLastError();
}

int dispatch(const Layout& l, int head_dim) {
  if (l.batch <= 0 || l.sq <= 0 || l.sk <= 0 || l.heads <= 0 || l.heads > 65535 ||
      l.batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  switch (head_dim) {
    case 32: return launch<32>(l);
    case 40: return launch<40>(l);
    case 64: return launch<64>(l);
    case 80: return launch<80>(l);
    case 128: return launch<128>(l);
    case 160: return launch<160>(l);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Strides are in elements; `delta`
// is the caller's scratch, 16-byte aligned: lse_pad and Delta_pad, fp32
// (B, H, Sq_pad) each with Sq_pad = Sq rounded up to 64, then Qs, bf16
// (B, Sq, H, D); `lse` the forward's contiguous fp32 (B, H, Sq). Every base address
// and stride must be a multiple of 16 bytes (the TMA's rule). Each returns
// the first CUDA error of its launches (0 on success); an operand the
// driver refuses a tensor map for returns cudaErrorInvalidPitchValue, an
// unsupported head_dim or an empty shape cudaErrorInvalidValue, both
// without launching.

// K1's layout: q, k, v, o, dout with a row and a batch stride each (head h at
// column h*D); dq, dk, dv contiguous (B, S, H*D).
extern "C" int flash_attn_nhd_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int sq, int sk,
    int heads, int head_dim, long long q_row, long long k_row, long long v_row, long long o_row,
    long long do_row, long long q_batch, long long k_batch, long long v_batch, long long o_batch,
    long long do_batch, float scale, float scale_log2, void* stream) {
  const int64_t hd = (int64_t)heads * head_dim;
  const Layout l{q, k, v, o, dout, lse, delta, dq, dk, dv, batch, sq, sk, heads,
                 {q_batch, head_dim, q_row}, {k_batch, head_dim, k_row},
                 {v_batch, head_dim, v_row}, {o_batch, head_dim, o_row},
                 {do_batch, head_dim, do_row},
                 {sq * hd, head_dim, hd}, {sk * hd, head_dim, hd}, {sk * hd, head_dim, hd},
                 scale, scale_log2, static_cast<cudaStream_t>(stream)};
  return dispatch(l, head_dim);
}

// K4's layout: every operand and output (B, H, S, D) with a batch, a head
// and a row stride (unit stride along D).
extern "C" int flash_attn_bhsd_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int sq, int sk,
    int heads, int head_dim,
    long long q_batch, long long q_head, long long q_row,
    long long k_batch, long long k_head, long long k_row,
    long long v_batch, long long v_head, long long v_row,
    long long o_batch, long long o_head, long long o_row,
    long long do_batch, long long do_head, long long do_row,
    long long dq_batch, long long dq_head, long long dq_row,
    long long dk_batch, long long dk_head, long long dk_row,
    long long dv_batch, long long dv_head, long long dv_row,
    float scale, float scale_log2, void* stream) {
  const Layout l{q, k, v, o, dout, lse, delta, dq, dk, dv, batch, sq, sk, heads,
                 {q_batch, q_head, q_row}, {k_batch, k_head, k_row}, {v_batch, v_head, v_row},
                 {o_batch, o_head, o_row}, {do_batch, do_head, do_row},
                 {dq_batch, dq_head, dq_row}, {dk_batch, dk_head, dk_row},
                 {dv_batch, dv_head, dv_row},
                 scale, scale_log2, static_cast<cudaStream_t>(stream)};
  return dispatch(l, head_dim);
}

// The dynamic shared memory each launch at head_dim asks for, in bytes:
// which = 0 for attn_bwd_dkdv_kernel, 1 for attn_bwd_dq_kernel; -1 for an
// unsupported head_dim.
extern "C" long long flash_attn_bwd_smem_bytes(int head_dim, int which) {
  switch (head_dim) {
    case 32: return which ? DqSmem<32>::kBytes : DkdvSmem<32>::kBytes;
    case 40: return which ? DqSmem<40>::kBytes : DkdvSmem<40>::kBytes;
    case 64: return which ? DqSmem<64>::kBytes : DkdvSmem<64>::kBytes;
    case 80: return which ? DqSmem<80>::kBytes : DkdvSmem<80>::kBytes;
    case 128: return which ? DqSmem<128>::kBytes : DkdvSmem<128>::kBytes;
    case 160: return which ? DqSmem<160>::kBytes : DkdvSmem<160>::kBytes;
    default: return -1;
  }
}

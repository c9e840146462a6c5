// P2-P4: the no-max attention of the attention probes, bf16 in and out,
// written for Hopper (sm_90a), one device kernel (`attn_nomax_wgmma_kernel`)
// under three schedules. On the packed (B, S, H*D) layout, per head:
//
//   qs = bf16(q * scale * log2(e)),  e = exp2(min(qs k^T, 115)) in fp32,
//   out = (sum_j bf16(e_j) v_j) / (sum_j e_j)
//
// with no running max and no rescale: the logits are clamped instead, so a
// key tile only adds to O and to the row sum. Keys at or past `kv_len`
// score -inf (exp2 gives 0). It replaces the TPU kernels
//   * P2 `_kblock_kernel` (tools/probe_attn_kblock.py:33), reached through
//     `kblock_attn` (:64, call :72): query blocks of bq rows, key blocks of
//     kb keys;
//   * P3 `_batchpack_kernel` (tools/probe_attn_kblock.py:89), through
//     `batchpack_attn` (:116, call :124): every batch row in one grid step;
//   * P4 `_attn_nhd_kernel` (imagharmony_tpu/kernels/flash_attention.py:415)
//     as `nhd_with_g` (tools/probe_attn_lanegroup.py:26, call :34) launches
//     it: G/D heads in one grid step, keys past kv_len masked.
// The three compute one function. Here a CTA takes 64 * NWG query rows
// (bq) of a list of (batch, head) units and walks them with BN keys a tile
// (kb): one unit for P2, every batch row of one head for P3, G/D heads of
// one batch row for P4. A unit's arithmetic does not depend on the list,
// so at the same (NWG, BN) the three give the same bits.
//
// What bounds it on an H100: at (2, 4096, 10, 64) 86 GFLOP (0.087 ms at
// 989 TFLOP/s) against 42 MB: the tensor cores, as for K1. The point of
// the probe is the softmax's share: K1 (flash_attn_nhd.cu, the same
// producer warp, ring, tiles and wgmma products) keeps a running row max,
// two shuffles a row and a tile to update it and a multiply of O by
// exp2(m_old - m_new); here the update is exp2f(fminf(s, 115)) and a sum.
//
// The clamp is the TPU kernel's: exact whenever the row's largest scaled
// logit is below 115, saturating above it. O and the row sum are not
// protected against overflow: 4096 keys at the clamp reach 2^127 in the sum
// and Σ e v overflows fp32 once |v| >= 2, as in the TPU kernel.
//
// Design (the parts that differ from K1's, see flash_attn_nhd.cu):
//   * a CTA: NWG consumer warpgroups of 64 query rows and one producer
//     warp. The producer brings each unit's Q tile (two Q buffers, so the
//     next unit's Q lands while this unit runs) and every unit's K and V
//     tiles through one ring of kStages stages that runs on across units.
//     A Q buffer is released (an mbarrier of NWG arrivals) once its
//     warpgroups' output stores, which go out through it, have read it.
//   * key tiles entirely at or past kv_len are not loaded (the TPU kernel
//     skips them too); the last one is masked in registers, which also
//     covers the zeros TMA fills in past Sk.
//   * instances: D = 32, 64 with BN = 64 or 128; D = 128 with BN = 64 (the
//     S accumulator of 128 keys and two O panels do not fit in the 168
//     registers a thread of a 288-thread block has); NWG = 1 or 2.

#include "sm90_tiles.cuh"

namespace {

using sm90::kPanelCols;
using sm90::kRowBytes;

constexpr int kStages = 2;
constexpr float kClamp = 115.f;  // the TPU kernels' _EXP2_ARG_MAX

struct NomaxMaps {
  sm90::Map q, k, v, o;
};

struct NomaxArgs {
  int sq, kv_len, heads_per_cta, batch_per_cta;
  float scale_log2;
};

// Shared memory of one CTA, in bytes from a 1024-aligned base: two Q tiles
// (NWG * 64 rows each), kStages stages of a K and a V tile (BN rows), the
// barriers (full and empty a stage, then Q full and Q empty a buffer).
template <int D, int NWG, int BN>
struct NomaxSmem {
  static constexpr int kQPanel = NWG * 64 * kRowBytes;
  static constexpr int kKVPanel = BN * kRowBytes;
  static constexpr int kQ = sm90::kPanels<D> * kQPanel;
  static constexpr int kKV = sm90::kPanels<D> * kKVPanel;
  static constexpr int kKVOff = 2 * kQ;
  static constexpr int kBars = kKVOff + 2 * kStages * kKV;
  static constexpr int kBytes = kBars + (2 * kStages + 4) * 8 + sm90::kSmemAlign;
};

template <int D, int NWG, int BN>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
attn_nomax_wgmma_kernel(const __grid_constant__ NomaxMaps maps, const NomaxArgs a) {
  using L = NomaxSmem<D, NWG, BN>;
  constexpr int kP = sm90::kPanels<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (sm90::kSmemAlign - sm90::smem_u32(smem_raw) % sm90::kSmemAlign) %
                                 sm90::kSmemAlign;
  uint8_t* sKV = smem + L::kKVOff;  // stage s: K at sKV + 2 s kKV, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;
  uint64_t* qempty = qfull + 2;

  const int m0 = blockIdx.x * NWG * 64;
  const int units = a.heads_per_cta * a.batch_per_cta;
  const int n_tiles = (a.kv_len + BN - 1) / BN;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NWG * 128);
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&qfull[i], 1);
      sm90::mbar_init(&qempty[i], NWG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // ---- producer: per unit its Q tile, then its K and V tiles ----
    if (threadIdx.x % 32 == 0) {
      int jg = 0;  // tiles through the ring so far, over every unit
      for (int u = 0; u < units; ++u) {
        const int h = blockIdx.y * a.heads_per_cta + u % a.heads_per_cta;
        const int b = blockIdx.z * a.batch_per_cta + u / a.heads_per_cta;
        const int qb = u & 1;
        if (u >= 2) sm90::mbar_wait(&qempty[qb], ((u >> 1) - 1) & 1);
        uint8_t* sQ = smem + qb * L::kQ;
        sm90::mbar_expect_tx(&qfull[qb], L::kQ);
        for (int p = 0; p < kP; ++p) {
          sm90::tma_load(sQ + p * L::kQPanel, maps.q, &qfull[qb], p * kPanelCols, h, m0, b);
        }
        for (int j = 0; j < n_tiles; ++j, ++jg) {
          const int s = jg % kStages;
          if (jg >= kStages) sm90::mbar_wait(&empty[s], (jg / kStages - 1) & 1);
          uint8_t* sK = sKV + 2 * s * L::kKV;
          uint8_t* sV = sK + L::kKV;
          sm90::mbar_expect_tx(&full[s], 2 * L::kKV);
          for (int p = 0; p < kP; ++p) {
            sm90::tma_load(sK + p * L::kKVPanel, maps.k, &full[s], p * kPanelCols, h, j * BN, b);
            sm90::tma_load(sV + p * L::kKVPanel, maps.v, &full[s], p * kPanelCols, h, j * BN, b);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows m0 + 64 wg .. + 63 of each unit ----
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  constexpr int kChunks = kP * kPanelCols / 8;  // 16-byte chunks a row
  int jg = 0;
  for (int u = 0; u < units; ++u) {
    const int h = blockIdx.y * a.heads_per_cta + u % a.heads_per_cta;
    const int b = blockIdx.z * a.batch_per_cta + u / a.heads_per_cta;
    const int qb = u & 1;
    uint8_t* sQ = smem + qb * L::kQ;

    // scale this warpgroup's Q rows by scale*log2(e), rounded to bf16
    sm90::mbar_wait(&qfull[qb], (u >> 1) & 1);
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
    // this thread's part of the row sums of rows g and g + 8 (its quad's
    // four parts add up at the end)
    float l_run[2] = {0.f, 0.f};

    for (int j = 0; j < n_tiles; ++j, ++jg) {
      const int s = jg % kStages;
      sm90::mbar_wait(&full[s], (jg / kStages) & 1);
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

      // ---- keys at or past kv_len (the last tile only) score -inf ----
      if ((j + 1) * BN > a.kv_len) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int key = j * BN + c * 64 + 8 * (e / 4) + 2 * t + (e & 1);
            if (key >= a.kv_len) sc[c][e] = -INFINITY;
          }
      }
      // ---- the no-max softmax: e = exp2(min(s, 115)), summed in fp32 ----
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const float pr = exp2f(fminf(sc[c][e], kClamp));
          sc[c][e] = pr;
          l_run[(e >> 1) & 1] += pr;
        }

      // ---- O += bf16(e) V: e from registers, V MN-major from the tile ----
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

    // ---- O / sum (1/0 = inf, as the TPU kernel's reciprocal), store
    // through this warpgroup's Q rows, then release the Q buffer ----
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv[r] = 1.f / l_run[r];
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
      sm90::mbar_arrive(&qempty[qb]);
    }
  }
}

template <int D, int NWG, int BN>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int sq, int sk,
           int heads,
           long long q_row, long long k_row, long long v_row, long long q_batch,
           long long k_batch, long long v_batch, const NomaxArgs& a, dim3 grid,
           cudaStream_t stream) {
  using L = NomaxSmem<D, NWG, BN>;
  const long long hd = (long long)heads * D;
  NomaxMaps maps;
  if (!sm90::make_map(&maps.q, q, D, heads, sq, batch, q_batch, D, q_row, NWG * 64) ||
      !sm90::make_map(&maps.k, k, D, heads, sk, batch, k_batch, D, k_row, BN) ||
      !sm90::make_map(&maps.v, v, D, heads, sk, batch, v_batch, D, v_row, BN) ||
      !sm90::make_map(&maps.o, o, D, heads, sq, batch, sq * hd, D, hd, 64)) {
    return (int)cudaErrorInvalidPitchValue;
  }
  static sm90::PerDevice smem_set;
  const cudaError_t err = sm90::allow_smem(
      reinterpret_cast<const void*>(attn_nomax_wgmma_kernel<D, NWG, BN>), L::kBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  attn_nomax_wgmma_kernel<D, NWG, BN><<<grid, NWG * 128 + 32, L::kBytes, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v packed (B, S, H*D)
// bf16 with a row and a batch stride each (elements; head h at column h*D,
// unit stride along D); o a contiguous (B, Sq, H*D) bf16 buffer. Keys at or
// past kv_len (1 <= kv_len <= sk) are masked. Tiles: 64 * nwg query rows
// (nwg 1 or 2) and bn keys (64 or 128; 64 at head_dim 128); head_dim 32,
// 64 or 128. Schedule: a CTA walks heads_per_cta heads (dividing heads)
// of batch_per_cta batch rows (dividing batch), one of the two being 1.
// Every base address and stride must be a multiple of 16 bytes (the TMA's
// rule). Returns cudaGetLastError() after the launch (0 on success); an
// operand whose tensor map cuTensorMapEncodeTiled refuses returns
// cudaErrorInvalidPitchValue, anything else it does not take
// cudaErrorInvalidValue, both without launching.
extern "C" int attn_nomax_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                               int sq, int sk, int kv_len, int heads, int head_dim, int nwg,
                               int bn, int heads_per_cta, int batch_per_cta, long long q_row,
                               long long k_row, long long v_row, long long q_batch,
                               long long k_batch, long long v_batch, float scale_log2,
                               void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || kv_len < 1 || kv_len > sk ||
      heads_per_cta < 1 || batch_per_cta < 1 || heads % heads_per_cta ||
      batch % batch_per_cta || (heads_per_cta > 1 && batch_per_cta > 1) ||
      heads / heads_per_cta > 65535 || batch / batch_per_cta > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const NomaxArgs a{sq, kv_len, heads_per_cta, batch_per_cta, scale_log2};
  const dim3 grid((sq + nwg * 64 - 1) / (nwg * 64), heads / heads_per_cta,
                  batch / batch_per_cta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NOMAX_LAUNCH(D, NWG, BN)                                                              \
  return launch<D, NWG, BN>(q, k, v, o, batch, sq, sk, heads, q_row, k_row, v_row, q_batch,   \
                            k_batch, v_batch, a, grid, st)
#define NOMAX_NWG(D, BN)                  \
  if (nwg == 1) NOMAX_LAUNCH(D, 1, BN);   \
  if (nwg == 2) NOMAX_LAUNCH(D, 2, BN);   \
  break
  switch (head_dim * 1000 + bn) {
    case 32064: NOMAX_NWG(32, 64);
    case 32128: NOMAX_NWG(32, 128);
    case 64064: NOMAX_NWG(64, 64);
    case 64128: NOMAX_NWG(64, 128);
    case 128064: NOMAX_NWG(128, 64);
    default: break;
  }
#undef NOMAX_NWG
#undef NOMAX_LAUNCH
  return (int)cudaErrorInvalidValue;
}

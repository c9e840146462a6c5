// P2-P6: the attention probes' softmax recipes, bf16 in and out, written for
// Hopper (sm_90a), one device kernel (`attn_nomax_wgmma_kernel`) with the
// recipe as a template parameter. On the packed (B, S, H*D) layout, per
// head, P2-P4's recipe (kClampF32):
//
//   qs = bf16(q * scale * log2(e)),  e = exp2(min(qs k^T, clamp)) in fp32,
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
//     it: G/D heads in one grid step, keys past kv_len masked;
//   * P5 `_kernel_variant` (tools/probe_softmax_nomax.py:32, through
//     `run_variant` :76, call :89) and P6 `_kernel_v`
//     (tools/probe_softmax_tricks.py:41, through `run_variant` :84, call
//     :89): the other recipes below, at the default tile.
// The first three compute one function. Here a CTA takes 64 * NWG query
// rows (bq) of a list of (batch, head) units and walks them with BN keys a
// tile (kb): one unit for P2, P5 and P6, every batch row of one head for P3,
// G/D heads of one batch row for P4. A unit's arithmetic does not depend on
// the list, so at the same (NWG, BN, recipe) the schedules give the same
// bits.
//
// The recipes (enum Recipe), what P5 and P6 measure on the TPU: whether the
// max pass, the sum pass and the scale multiply are worth removing. The TPU
// kernels hold a whole key row in a grid step; a CTA here cannot (K of 4096
// keys at d = 64 is 512 KB against 227 KB of shared memory), so the keys
// stream and the recipes compute the same functions this way:
//   * max-subtract (kMaxExp2, kMaxExp2Ones, kMaxExp): K1's running max, its
//     quad shuffles and the rescale of O and of the row sum by
//     exp2(m_old - m_new) in fp32; the exp argument bf16(s - m_running).
//   * a bf16 argument: x rounded to bf16 before the exp, e rounded to bf16
//     after it, and the row sum over the rounded e. Two elements of a row
//     are rounded by one conversion (cvt.rn.bf16x2.f32), and the rounded e
//     pair is the PV product's A fragment as it is: a conversion an element
//     in all, against half of one for the fp32 argument.
//   * natural exp (kMaxExp, kNormFirst): e = exp2f(x * log2(e)), one
//     multiply before the MUFU op; the scale folded into Q has no log2(e).
//   * the ones column (the *Ones recipes): a constant panel of bf16 ones in
//     shared memory, one m64n8k16 product a 16-key step beside PV; every
//     column of that accumulator is the row sum of bf16(e), so no register
//     sum is kept.
//   * kNormFirst (P6 v0): Q is not scaled, the fp32 logits are multiplied by
//     the scale; a statistics pass over the K tiles alone keeps the running
//     max and the rescaled sum of bf16(e), then the PV pass recomputes S with
//     the row's final max and multiplies each bf16 e by bf16(1 / sum) before
//     the product: the second QK^T is what normalising first costs here.
//
// What bounds it on an H100: at (2, 4096, 10, 64) 86 GFLOP (0.087 ms at
// 989 TFLOP/s) against 42 MB: the tensor cores, as for K1 (the statistics
// pass adds a third of the products, not of the function's work).
//
// The clamp is the TPU kernels': exact whenever the row's largest scaled
// logit is below it, saturating above it (115 for P2-P4, 80 log2(e) for
// P5). O and the row sum are not protected against overflow: 4096 keys at
// the clamp reach 2^127 (2^127.42) in the sum and Σ e v overflows fp32 once
// |v| >= 2, as in the TPU kernels.
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
//   * instances: kClampF32 at D = 32, 64 with BN = 64 or 128 and D = 128
//     with BN = 64 (the S accumulator of 128 keys and two O panels do not
//     fit in the 168 registers a thread of a 288-thread block has), NWG = 1
//     or 2; every other recipe at the default tile only (NWG = 2, BN = 128,
//     64 at D = 128), since the TPU tools that run them have no tile knob.

#include "sm90_tiles.cuh"

namespace {

using sm90::kPanelCols;
using sm90::kRowBytes;

constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// How a recipe turns a tile's logits s into the e of the PV product and of
// the row sum (the C entry point's `recipe`; RECIPES in
// kernels/probe_softmax.py).
enum Recipe : int {
  kClampF32 = 0,       // e = exp2(min(s, clamp)), the fp32 e summed (P2-P4; P5 "fp32")
  kMaxExp2 = 1,        // e = bf16(exp2(bf16(s - m))), m the row max (P5 base, P6 v2)
  kMaxExp2Ones = 2,    // kMaxExp2, the sum from the ones column
  kClampBf16 = 3,      // e = bf16(exp2(bf16(min(s, clamp)))) (P5 no_max=True)
  kClampBf16Ones = 4,  // kClampBf16, the sum from the ones column
  kClampF32Ones = 5,   // kClampF32, the sum of bf16(e) from the ones column
  kMaxExp = 6,         // e = bf16(exp(bf16(s - m))), s in natural units (P6 v1)
  kNormFirst = 7,      // P6 v0: s = (q k^T) scale, e as kMaxExp, PV of bf16(e bf16(1 / sum))
};

template <int R>
struct Traits {
  static constexpr bool max_sub =
      R == kMaxExp2 || R == kMaxExp2Ones || R == kMaxExp || R == kNormFirst;
  static constexpr bool bf16_arg = R != kClampF32 && R != kClampF32Ones;
  static constexpr bool ones = R == kMaxExp2Ones || R == kClampBf16Ones || R == kClampF32Ones;
  static constexpr bool natural = R == kMaxExp || R == kNormFirst;
  static constexpr bool norm_first = R == kNormFirst;
};

// Two floats rounded to bf16 by one conversion (cvt.rn.bf16x2.f32).
__device__ __forceinline__ __nv_bfloat162 bf16_pair(float lo, float hi) {
  return __floats2bfloat162_rn(lo, hi);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

struct NomaxMaps {
  sm90::Map q, k, v, o;
};

struct NomaxArgs {
  int sq, kv_len, heads_per_cta, batch_per_cta;
  float scale_q;  // Q's rows times this, rounded to bf16 (every recipe but kNormFirst)
  float scale_s;  // kNormFirst: the fp32 logits times this
  float clamp;    // the clamp recipes' bound on the exp2 argument
};

// Shared memory of one CTA, in bytes from a 1024-aligned base: two Q tiles
// (NWG * 64 rows each), kStages stages of a K and a V tile (BN rows), the
// ones panel (8 rows of 64 bf16 ones, the ones recipes only), the barriers
// (full and empty a stage, then Q full and Q empty a buffer).
template <int D, int NWG, int BN, bool kOnes>
struct NomaxSmem {
  static constexpr int kQPanel = NWG * 64 * kRowBytes;
  static constexpr int kKVPanel = BN * kRowBytes;
  static constexpr int kQ = sm90::kPanels<D> * kQPanel;
  static constexpr int kKV = sm90::kPanels<D> * kKVPanel;
  static constexpr int kKVOff = 2 * kQ;
  static constexpr int kOnesOff = kKVOff + 2 * kStages * kKV;  // 1024-aligned: kKV is
  static constexpr int kBars = kOnesOff + (kOnes ? 8 * kRowBytes : 0);
  static constexpr int kBytes = kBars + (2 * kStages + 4) * 8 + sm90::kSmemAlign;
};

template <int D, int NWG, int BN, int R>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
attn_nomax_wgmma_kernel(const __grid_constant__ NomaxMaps maps, const NomaxArgs a) {
  using T = Traits<R>;
  using L = NomaxSmem<D, NWG, BN, T::ones>;
  constexpr int kP = sm90::kPanels<D>;
  constexpr int kPasses = T::norm_first ? 2 : 1;  // kNormFirst: statistics, then PV
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
  if constexpr (T::ones) {
    // B of the row-sum product: bf16 1.0 is 0x3f80
    uint32_t* ones = reinterpret_cast<uint32_t*>(smem + L::kOnesOff);
    for (int i = threadIdx.x; i < 8 * kRowBytes / 4; i += blockDim.x) ones[i] = 0x3f803f80u;
    sm90::fence_async_shared();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // ---- producer: per unit its Q tile, then its K and V tiles (K alone
    // for kNormFirst's statistics pass) ----
    if (threadIdx.x % 32 == 0) {
      int jg = 0;  // tiles through the ring so far, over every unit and pass
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
        for (int pass = 0; pass < kPasses; ++pass) {
          const bool with_v = pass == kPasses - 1;
          for (int j = 0; j < n_tiles; ++j, ++jg) {
            const int s = jg % kStages;
            if (jg >= kStages) sm90::mbar_wait(&empty[s], (jg / kStages - 1) & 1);
            uint8_t* sK = sKV + 2 * s * L::kKV;
            uint8_t* sV = sK + L::kKV;
            sm90::mbar_expect_tx(&full[s], (with_v ? 2 : 1) * L::kKV);
            for (int p = 0; p < kP; ++p) {
              sm90::tma_load(sK + p * L::kKVPanel, maps.k, &full[s], p * kPanelCols, h, j * BN, b);
              if (with_v) {
                sm90::tma_load(sV + p * L::kKVPanel, maps.v, &full[s], p * kPanelCols, h, j * BN,
                               b);
              }
            }
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
  const uint64_t ones_desc = sm90::desc_k(smem + L::kOnesOff);
  // the lambdas below read these, not the kernel's parameter
  const int kv_len = a.kv_len;
  const float scale_s = a.scale_s, clamp = a.clamp;
  int jg = 0;
  for (int u = 0; u < units; ++u) {
    const int h = blockIdx.y * a.heads_per_cta + u % a.heads_per_cta;
    const int b = blockIdx.z * a.batch_per_cta + u / a.heads_per_cta;
    const int qb = u & 1;
    uint8_t* sQ = smem + qb * L::kQ;

    sm90::mbar_wait(&qfull[qb], (u >> 1) & 1);
    if constexpr (!T::norm_first) {
      // scale this warpgroup's Q rows by scale_q, rounded to bf16
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
          w[e] = sm90::pack_bf16x2(__low2float(x) * a.scale_q, __high2float(x) * a.scale_q);
        }
        *ptr = val;
      }
      sm90::fence_async_shared();
      sm90::named_bar(1 + wg, 128);
    }

    const uint8_t* q_rows = sQ + wg * 64 * kRowBytes;
    // rows g and g + 8 of this thread's warp slice: the running max (the
    // max-subtract recipes; the quad's four threads hold the same) and this
    // thread's part of the row sum (its quad's four parts add up at the end)
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    // S = Q K^T of key tile j (log2 units; kNormFirst: natural, scaled),
    // keys at or past kv_len (the last tile only) at -inf
    auto logits = [&](float (&sc)[BN / 64][32], const uint8_t* sK, int j) {
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
      if constexpr (T::norm_first) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) sc[c][e] *= scale_s;
      }
      if ((j + 1) * BN > kv_len) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int key = j * BN + c * 64 + 8 * (e / 4) + 2 * t + (e & 1);
            if (key >= kv_len) sc[c][e] = -INFINITY;
          }
      }
    };
    // the running max taken over a tile: the max to subtract (0 while a
    // row has no key: exp(-inf - 0) = 0, no NaN) and the factor the earlier
    // tiles' sums are rescaled by
    auto take_max = [&](const float (&sc)[BN / 64][32], float (&base)[2], float (&alpha)[2]) {
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[c][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        const float d = m_run[r] - base[r];
        alpha[r] = exp2f(T::natural ? d * kLog2e : d);
        m_run[r] = mx[r];
      }
    };
    // e of the bf16-argument recipes for two logits of one row (elements e
    // and e + 1 of an accumulator), `base` the max to subtract: the
    // arguments rounded to bf16 by one conversion, the recipe's exp, and the
    // two e rounded to bf16 by another, which the PV product takes as they
    // are
    auto exp_pair = [&](float s0, float s1, float base) {
      const __nv_bfloat162 x = T::max_sub ? bf16_pair(s0 - base, s1 - base)
                                          : bf16_pair(fminf(s0, clamp), fminf(s1, clamp));
      float x0 = __low2float(x), x1 = __high2float(x);
      if constexpr (T::natural) {
        x0 *= kLog2e;
        x1 *= kLog2e;
      }
      return bf16_pair(exp2f(x0), exp2f(x1));
    };

    // ---- kNormFirst's statistics pass: the row max and the sum of bf16(e)
    // over every key, then bf16(1 / sum) ----
    float norm[2] = {1.f, 1.f};
    if constexpr (T::norm_first) {
      for (int j = 0; j < n_tiles; ++j, ++jg) {
        const int s = jg % kStages;
        sm90::mbar_wait(&full[s], (jg / kStages) & 1);
        float sc[BN / 64][32];
        logits(sc, sKV + 2 * s * L::kKV, j);
        sm90::mbar_arrive(&empty[s]);  // the products have read K
        float base[2], alpha[2];
        take_max(sc, base, alpha);
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] *= alpha[r];
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            const int r = (e >> 1) & 1;
            const __nv_bfloat162 pr = exp_pair(sc[c][e], sc[c][e + 1], base[r]);
            l_run[r] += __low2float(pr);
            l_run[r] += __high2float(pr);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        norm[r] = __bfloat162float(__float2bfloat16_rn(1.f / l_run[r]));
      }
    }

    // ---- the PV pass ----
    float o[kP][32];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[p][e] = 0.f;
    float rows[4] = {0.f, 0.f, 0.f, 0.f};  // the ones recipes: the row sums (rows g, g + 8)
    for (int j = 0; j < n_tiles; ++j, ++jg) {
      const int s = jg % kStages;
      sm90::mbar_wait(&full[s], (jg / kStages) & 1);
      const uint8_t* sK = sKV + 2 * s * L::kKV;
      const uint8_t* sV = sK + L::kKV;

      float sc[BN / 64][32];
      logits(sc, sK, j);
      float base[2] = {0.f, 0.f};
      if constexpr (T::norm_first) {
#pragma unroll
        for (int r = 0; r < 2; ++r) base[r] = m_run[r] == -INFINITY ? 0.f : m_run[r];
      } else if constexpr (T::max_sub) {
        float alpha[2];
        take_max(sc, base, alpha);
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] *= alpha[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) rows[i] *= alpha[i >> 1];
#pragma unroll
        for (int p = 0; p < kP; ++p)
#pragma unroll
          for (int e = 0; e < 32; ++e) o[p][e] *= alpha[(e >> 1) & 1];
      }
      // the A fragments of PV: the pair (e, e + 1) of accumulator c is
      // entry (e % 8) / 2 of contraction step 4 c + e / 8 (see pack_a)
      uint32_t pa[BN / 16][4];
      if constexpr (T::bf16_arg) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            const int r = (e >> 1) & 1;
            const __nv_bfloat162 pr = exp_pair(sc[c][e], sc[c][e + 1], base[r]);
            uint32_t& a_pair = pa[4 * c + e / 8][(e % 8) / 2];
            if constexpr (T::norm_first) {
              // bf16 e times bf16(1 / sum) is exact in fp32, then rounded
              // to bf16, as the TPU kernel's bf16 product
              a_pair = bits(bf16_pair(__low2float(pr) * norm[r], __high2float(pr) * norm[r]));
            } else {
              a_pair = bits(pr);
              if constexpr (!T::ones) {
                l_run[r] += __low2float(pr);
                l_run[r] += __high2float(pr);
              }
            }
          }
      } else {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const float pr = exp2f(fminf(sc[c][e], clamp));
            sc[c][e] = pr;
            if constexpr (!T::ones) l_run[(e >> 1) & 1] += pr;
          }
#pragma unroll
        for (int k = 0; k < BN / 16; ++k) sm90::pack_a(pa[k], sc[k / 4], k % 4);
      }

      // ---- O += bf16(e) V: e from registers, V MN-major from the tile;
      // the ones recipes' row sums beside it ----
      sm90::wgmma_fence();
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int k = 0; k < BN / 16; ++k) {
          sm90::wgmma_rs(o[p], pa[k], sm90::desc_mn(sV + p * L::kKVPanel + k * 16 * kRowBytes));
        }
      if constexpr (T::ones) {
#pragma unroll
        for (int k = 0; k < BN / 16; ++k) sm90::wgmma_rs_n8(rows, pa[k], ones_desc);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
#pragma unroll
      for (int p = 0; p < kP; ++p) sm90::fence_regs(o[p]);
      if constexpr (T::ones) sm90::fence_regs(rows);
      sm90::mbar_arrive(&empty[s]);
    }

    // ---- O / sum (1/0 = inf, as the TPU kernel's reciprocal; kNormFirst
    // is normalised already), store through this warpgroup's Q rows, then
    // release the Q buffer ----
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (T::norm_first) {
        inv[r] = 1.f;
      } else if constexpr (T::ones) {
        inv[r] = 1.f / rows[2 * r];
      } else {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        inv[r] = 1.f / l_run[r];
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
      sm90::mbar_arrive(&qempty[qb]);
    }
  }
}

template <int D, int NWG, int BN, int R>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int sq, int sk,
           int heads,
           long long q_row, long long k_row, long long v_row, long long q_batch,
           long long k_batch, long long v_batch, const NomaxArgs& a, dim3 grid,
           cudaStream_t stream) {
  using L = NomaxSmem<D, NWG, BN, Traits<R>::ones>;
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
      reinterpret_cast<const void*>(attn_nomax_wgmma_kernel<D, NWG, BN, R>), L::kBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  attn_nomax_wgmma_kernel<D, NWG, BN, R><<<grid, NWG * 128 + 32, L::kBytes, stream>>>(maps, a);
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
// recipe: a Recipe; every one but kClampF32 only at nwg 2 and bn 128 (64
// at head_dim 128). scale_q multiplies Q (every recipe but kNormFirst),
// scale_s the logits (kNormFirst), clamp bounds the clamp recipes' exp2
// argument. Every base address and stride must be a multiple of 16 bytes
// (the TMA's rule). Returns cudaGetLastError() after the launch (0 on
// success); an operand whose tensor map cuTensorMapEncodeTiled refuses
// returns cudaErrorInvalidPitchValue, anything else it does not take
// cudaErrorInvalidValue, both without launching.
extern "C" int attn_nomax_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                               int sq, int sk, int kv_len, int heads, int head_dim, int nwg,
                               int bn, int heads_per_cta, int batch_per_cta, long long q_row,
                               long long k_row, long long v_row, long long q_batch,
                               long long k_batch, long long v_batch, int recipe, float scale_q,
                               float scale_s, float clamp, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || kv_len < 1 || kv_len > sk ||
      heads_per_cta < 1 || batch_per_cta < 1 || heads % heads_per_cta ||
      batch % batch_per_cta || (heads_per_cta > 1 && batch_per_cta > 1) ||
      heads / heads_per_cta > 65535 || batch / batch_per_cta > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const NomaxArgs a{sq, kv_len, heads_per_cta, batch_per_cta, scale_q, scale_s, clamp};
  const dim3 grid((sq + nwg * 64 - 1) / (nwg * 64), heads / heads_per_cta,
                  batch / batch_per_cta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NOMAX_LAUNCH(D, NWG, BN, R)                                                           \
  return launch<D, NWG, BN, R>(q, k, v, o, batch, sq, sk, heads, q_row, k_row, v_row,         \
                               q_batch, k_batch, v_batch, a, grid, st)
#define NOMAX_NWG(D, BN)                                \
  if (nwg == 1) NOMAX_LAUNCH(D, 1, BN, kClampF32);      \
  if (nwg == 2) NOMAX_LAUNCH(D, 2, BN, kClampF32);      \
  break
#define NOMAX_RECIPE(D, BN)                                      \
  switch (recipe) {                                              \
    case kMaxExp2: NOMAX_LAUNCH(D, 2, BN, kMaxExp2);             \
    case kMaxExp2Ones: NOMAX_LAUNCH(D, 2, BN, kMaxExp2Ones);     \
    case kClampBf16: NOMAX_LAUNCH(D, 2, BN, kClampBf16);         \
    case kClampBf16Ones: NOMAX_LAUNCH(D, 2, BN, kClampBf16Ones); \
    case kClampF32Ones: NOMAX_LAUNCH(D, 2, BN, kClampF32Ones);   \
    case kMaxExp: NOMAX_LAUNCH(D, 2, BN, kMaxExp);               \
    case kNormFirst: NOMAX_LAUNCH(D, 2, BN, kNormFirst);         \
    default: break;                                              \
  }                                                              \
  break
  if (recipe == kClampF32) {
    switch (head_dim * 1000 + bn) {
      case 32064: NOMAX_NWG(32, 64);
      case 32128: NOMAX_NWG(32, 128);
      case 64064: NOMAX_NWG(64, 64);
      case 64128: NOMAX_NWG(64, 128);
      case 128064: NOMAX_NWG(128, 64);
      default: break;
    }
  } else if (nwg == 2) {
    switch (head_dim * 1000 + bn) {
      case 32128: NOMAX_RECIPE(32, 128);
      case 64128: NOMAX_RECIPE(64, 128);
      case 128064: NOMAX_RECIPE(128, 64);
      default: break;
    }
  }
#undef NOMAX_RECIPE
#undef NOMAX_NWG
#undef NOMAX_LAUNCH
  return (int)cudaErrorInvalidValue;
}

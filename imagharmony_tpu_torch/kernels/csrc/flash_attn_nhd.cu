// K1 and K4: fused self-attention, bf16 in and out, two device kernels.
//
//   * K1, `flash_attn_nhd_bf16`: the packed (B, S, H*D) layout, head h at
//     column h*D, q/k/v as column views of one to_qkv output. Replaces the
//     TPU kernel `_attn_nhd_kernel` (imagharmony_tpu/kernels/
//     flash_attention.py:415), reached through `flash_attention_nhd` (:576).
//     Head dims 32, 64, 128. Device kernel: `attn_fwd_wgmma_kernel` below,
//     written for Hopper (sm_90a).
//   * K4, `flash_attn_bhsd_bf16`: the head-split (B, H, S, D) layout with a
//     batch, head and row stride for q, k, v and the output. Replaces the TPU
//     kernel `_attn_kernel` (:95), reached through `flash_attention` (:369) ->
//     `_flash_fwd_impl` (:138). Head dims 32, 40, 64, 80, 128, 160. Device
//     kernel: `flash_attn_kernel`, the mma.sync kernel K1 also ran until it
//     got its own; K4 keeps it until its own redesign.
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
// ridge. So they are bound by the tensor cores, and both keep the (Sq, Sk)
// logits out of device memory: they live in registers, one key tile at a
// time.
//
// K1's design (attn_fwd_wgmma_kernel), for the tensor cores' wgmma rate:
//   * one CTA per 64 * NWG query rows of one head: NWG consumer warpgroups
//     of 64 rows each and one producer warp. NWG = 2 where that still gives
//     a full wave of CTAs (SDXL's 1024² shapes), else 1 (training's batch 1:
//     (1, 256, 20, 64) is 80 CTAs of 64 rows, 40 of 128).
//   * the producer warp brings Q once and then every K and V tile with TMA
//     (sm90_tiles.cuh) into a ring of kFwdStages stages, each with a "full"
//     mbarrier (the copies' bytes) and an "empty" one (every consumer thread
//     arrives when its products are done with the stage), so the next
//     tiles' copies overlap this tile's math. The tensor maps are 4-D over
//     (d, h, s, b) with the operands' own strides: column views of to_qkv go
//     in as they are, and rows past S come in as zeros (keys past Sk are
//     then masked to -inf here: a zero key would score 0, not -inf).
//   * each consumer warpgroup scales its 64 Q rows in shared memory once,
//     then per key tile: S = Q K^T by wgmma (both K-major from shared
//     memory), the online-softmax update in registers, and O += P V by wgmma
//     with P from registers (the accumulator layout is the A-fragment
//     layout) and V read MN-major from the same tile: no transposed copy.
//   * BN keys per tile: 128 at D <= 64, 64 at D = 128 (registers: the S
//     accumulator is BN/2 a thread, O D/2).
//   * the output goes back through the Q tile in shared memory and TMA
//     stores, which leave out the rows past Sq and the columns past D.
//
// K4's kernel (flash_attn_kernel), simple and correct first: grid
// (ceil(Sq/64), H, B), one CTA of 4 warps per 64 query rows, each warp 16
// rows; K and V tiles of 64 rows staged in shared memory (V transposed) by
// all threads; QK^T and PV by mma.sync.m16n8k16 with fp32 accumulation. The
// QK^T contraction runs over D rounded up to 16 with the extra columns zero
// in shared memory only (40 -> 48), where the Pallas kernel pads D to a
// multiple of 64 and Sk to 256 on the host.

#include "attn_tiles.cuh"
#include "sm90_tiles.cuh"

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

// K4's launch at head_dim. Returns cudaGetLastError() after the launch (0
// on success); an unsupported head_dim or an empty shape returns
// cudaErrorInvalidValue without launching.
int dispatch(const Args& a, int head_dim) {
  if (a.batch <= 0 || a.sq <= 0 || a.sk <= 0 || a.heads <= 0 || a.heads > 65535 ||
      a.batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
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

// ---- K1: attn_fwd_wgmma_kernel ------------------------------------------------

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

template <int D, int NWG>
int launch_fwd(const void* q, const void* k, const void* v, void* o, const FwdArgs& a,
               int batch, long long q_row, long long k_row, long long v_row, long long q_batch,
               long long k_batch, long long v_batch, cudaStream_t stream) {
  using L = FwdSmem<D, NWG>;
  const long long hd = (long long)a.heads * D;
  FwdMaps maps;
  if (!sm90::make_map(&maps.q, q, D, a.heads, a.sq, batch, q_batch, D, q_row, NWG * 64) ||
      !sm90::make_map(&maps.k, k, D, a.heads, a.sk, batch, k_batch, D, k_row, kFwdKeys<D>) ||
      !sm90::make_map(&maps.v, v, D, a.heads, a.sk, batch, v_batch, D, v_row, kFwdKeys<D>) ||
      !sm90::make_map(&maps.o, o, D, a.heads, a.sq, batch, a.sq * hd, D, hd, 64)) {
    return (int)cudaErrorInvalidPitchValue;
  }
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_wgmma_kernel<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((a.sq + NWG * 64 - 1) / (NWG * 64), a.heads, batch);
  attn_fwd_wgmma_kernel<D, NWG><<<grid, NWG * 128 + 32, L::kBytes, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Strides are in elements.

// K1: packed (B, S, H*D) q, k, v with a row and a batch stride each (head h
// at column h*D); o is a contiguous (B, Sq, H*D) buffer; lse is null or a
// contiguous fp32 (B, H, Sq) buffer. head_dim 32, 64 or 128. Every base
// address and stride must be a multiple of 16 bytes (the TMA's rule): an
// operand the driver refuses a tensor map for returns
// cudaErrorInvalidPitchValue, an unsupported head_dim or an empty shape
// cudaErrorInvalidValue, both without launching. Else the launch's
// cudaGetLastError() (0 on success).
extern "C" int flash_attn_nhd_bf16(const void* q, const void* k, const void* v, void* o,
                                   float* lse,
                                   int batch, int sq, int sk, int heads, int head_dim,
                                   long long q_row, long long k_row, long long v_row,
                                   long long q_batch, long long k_batch,
                                   long long v_batch, float scale_log2, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const FwdArgs a{lse, sq, sk, heads, scale_log2};
  // two warpgroups a CTA where that still fills the card with CTAs
  const bool wide = (long long)((sq + 127) / 128) * heads * batch >= sm90::sm_count();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K1_LAUNCH(D)                                                                          \
  return wide ? launch_fwd<D, 2>(q, k, v, o, a, batch, q_row, k_row, v_row, q_batch, k_batch, \
                                 v_batch, st)                                                 \
              : launch_fwd<D, 1>(q, k, v, o, a, batch, q_row, k_row, v_row, q_batch, k_batch, \
                                 v_batch, st)
  switch (head_dim) {
    case 32: K1_LAUNCH(32);
    case 64: K1_LAUNCH(64);
    case 128: K1_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_LAUNCH
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
  return dispatch(a, head_dim);
}

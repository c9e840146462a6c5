// The GEMM mainloop of the port's Hopper (sm_90a) matrix kernels, written
// once: P1 (probe_mm.cu, x W in bf16 and int8) and K5 (geglu.cu, the fused
// GEGLU projection) are this loop with their own loads, products and
// epilogue (an "Op", below). On the helpers of sm90_tiles.cuh.
//
// A block is 384 threads: two consumer warpgroups (threads 0-255) and one
// producer warpgroup, whose first thread issues every TMA load. The
// producer gives its registers to the consumers (setmaxnreg: Op::
// kProducerRegs and kConsumerRegs, 128 * P + 256 * C = 168 * 384, the
// count __launch_bounds__(384, 1) gives at entry), so a consumer thread
// holds a full m64n256 fp32 accumulator (128 registers) and the epilogue.
// The two roles part in one if/else at the top and never meet again, or
// ptxas ignores setmaxnreg.
//
// A tile is 128 rows (64 a consumer warpgroup, cooperative: both work on
// one tile) by the Op's columns; a stage of the mbarrier ring holds one
// 128-byte panel of K of the x tile and of the W tile. Consumers only arrive
// on a stage's `empty` barrier (one arrival a warp, after the products
// that read it are done); only the producer waits on it.
//
// Persistent: the grid is at most one CTA per SM, and each CTA walks work
// units from a static schedule (Sched), the same walk in the producer and
// the consumers, with the ring's stage and phase carried across units. The
// producer runs ahead into the next unit's panels while the consumers run
// the epilogue; the epilogue's TMA stores stay in flight and are drained
// only before their staging buffer is written again.
//
// Schedule: tiles in groups of kGroupM row tiles that walk each column
// tile together (x and W tiles stay in L2 while the CTAs of a wave use
// them). Tiles [0, dp_tiles) are whole units, unit c + i * grid to CTA c.
// Where whole tiles would leave the card's last wave part empty, the last
// sk_tiles are split along K into `chunks` (2 to kMaxChunks) and their
// chunks are dealt out after the whole tiles, chunk-major, so the CTAs of a
// round read the same K panels of x and W at the same time (a stream-K
// spread, each CTA a contiguous run of panels, reads them at scattered K
// offsets: it measured 1.25-1.6x slower than chunks, PERF.md). A chunk
// stores its accumulator (fp32 or int32, in the fragment layout) to its
// workspace slot and counts itself on the tile's counter; the chunk that
// counts last sums the chunks' partials in K order as its epilogue reads
// them (so two calls on the same inputs give the same bits, whichever CTA
// came last), sets the counter back to 0 for the next launch, and runs the
// epilogue. No CTA waits for another. plan() picks the cut from a cost in
// panels (kTileCost, kSplitCost).

#pragma once

#include <algorithm>
#include <type_traits>

#include "sm90_tiles.cuh"

namespace sm90 {
namespace gemm {

constexpr int kBM = 128;                    // rows of a tile: two consumer warpgroups of 64
constexpr int kConsumers = 256;             // threads 0-255
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kReleases = kConsumers / 32;  // arrivals that free a stage: one a consumer warp
constexpr int kGroupM = 8;                  // row tiles that walk each column tile together
constexpr int kMaxCounters = 1024;          // tile counters the caller provides, zeroed once
constexpr int kMaxChunks = 4;               // K chunks a split tile is cut into, at most

// The work of one launch (see above).
struct Sched {
  int tiles_m, tiles_n, nk;  // tiles, and K panels a tile
  int grid;                  // CTAs
  int dp_tiles;              // tiles [0, dp_tiles): whole
  int sk_tiles;              // tiles [dp_tiles, dp_tiles + sk_tiles): split along K
  int chunks;                // K chunks a split tile is cut into (2 .. kMaxChunks)
};

// Shared memory of a CTA, in bytes from a 1024-aligned base: the ring's
// stages, two transposed W panels (Ops whose products cannot read W as TMA
// brings it), two output staging buffers (one a consumer warpgroup),
// kExtraBytes a consumer warpgroup for the epilogue's own use, the
// barriers and the "last chunk" flag.
template <class Op>
struct Layout {
  static constexpr int kTOff = Op::kStages * Op::kStageBytes;
  static constexpr int kOutOff = kTOff + 2 * Op::kTBytes;
  static constexpr int kExtraOff = kOutOff + 2 * Op::kOutBytes;
  static constexpr int kBars = kExtraOff + 2 * Op::kExtraBytes;
  static constexpr int kBytes = kBars + 2 * Op::kStages * 8 + 16 + kSmemAlign;
  static_assert(kBytes <= 232448, "more shared memory than a block may use");
  static_assert(128 * Op::kProducerRegs + kConsumers * Op::kConsumerRegs <= 168 * kThreads,
                "the warpgroups ask for more registers than the block holds");
};

// A work unit: K panels [kb, ke) of one tile.
struct Unit {
  int tile, kb, ke;
  int pieces;  // units that share the tile (1: whole)
  int slot;    // the workspace slot of this unit's partial: chunk j of split
               // tile st is at j * sk_tiles + st
};

// One CTA's walk over its units, the whole tiles and then the split
// tiles' chunks, chunk-major (every split tile's chunk 0, then chunk 1, ...),
// unit c + i * grid to CTA c; the producer and the consumers each run one
// and get the same units in the same order.
struct Walk {
  const Sched& s;
  int unit;

  __device__ explicit Walk(const Sched& sched) : s(sched), unit(blockIdx.x) {}

  __device__ bool next(Unit& u) {
    if (unit >= s.dp_tiles + s.sk_tiles * s.chunks) return false;
    if (unit < s.dp_tiles) {
      u.tile = unit;
      u.kb = 0;
      u.ke = s.nk;
      u.pieces = 1;
    } else {
      u.slot = unit - s.dp_tiles;
      const int j = u.slot / s.sk_tiles;
      u.tile = s.dp_tiles + u.slot % s.sk_tiles;
      u.kb = s.nk * j / s.chunks;
      u.ke = s.nk * (j + 1) / s.chunks;
      u.pieces = s.chunks;
    }
    unit += gridDim.x;
    return true;
  }
};

// Tile t's row and column tile: kGroupM row tiles at a time, row fastest.
__device__ __forceinline__ void raster(const Sched& s, int t, int& tm, int& tn) {
  const int per_group = kGroupM * s.tiles_n;
  const int first = t / per_group * kGroupM;
  const int rows = min(s.tiles_m - first, kGroupM);
  const int local = t % per_group;
  tm = first + local % rows;
  tn = local / rows;
}

template <class T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<int> {
  using type = int4;
};

// A chunk of a split tile: store the partial (the fragment layout: a
// thread's four values a vector, the 256 threads' vectors side by side),
// count it; false for all but the chunk that counted last, whose acc then
// becomes the tile's sum over the chunks' partials, its own re-read, in K
// order. Chunk 0's partial is loaded straight into acc (every load in
// flight at once, no register beside acc), the others 16 vectors at a time.
template <class Op>
__device__ __forceinline__ bool fixup(const typename Op::Params& p,
                                      typename Op::Acc (&acc)[Op::kAcc], const Unit& u,
                                      int* last) {
  using V = typename Vec4<typename Op::Acc>::type;
  constexpr int kV = Op::kAcc / 4;
  constexpr long long kSlot = (long long)kV * kConsumers;  // vectors in a slot
  V* ws = static_cast<V*>(p.workspace) + threadIdx.x;
  V* mine = ws + u.slot * kSlot;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    __stcg(mine + i * kConsumers, V{acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]});
  }
  __threadfence();
  named_bar(1, kConsumers);
  const int st = u.tile - p.sched.dp_tiles;
  if (threadIdx.x == 0) {
    const int done = atomicAdd(p.counters + st, 1) == u.pieces - 1;
    if (done) atomicExch(p.counters + st, 0);  // every chunk has counted
    *last = done;
  }
  named_bar(1, kConsumers);
  if (!*reinterpret_cast<volatile int*>(last)) return false;
  __threadfence();
  const V* src = ws + st * kSlot;  // chunk 0; chunk q at q * sk_tiles slots further
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const V v = __ldcg(src + i * kConsumers);
    acc[4 * i] = v.x;
    acc[4 * i + 1] = v.y;
    acc[4 * i + 2] = v.z;
    acc[4 * i + 3] = v.w;
  }
  for (int q = 1; q < u.pieces; ++q) {
    src += p.sched.sk_tiles * kSlot;
#pragma unroll
    for (int b = 0; b < kV; b += 16) {
      V v[16];
#pragma unroll
      for (int i = 0; i < 16 && b + i < kV; ++i) v[i] = __ldcg(src + (b + i) * kConsumers);
#pragma unroll
      for (int i = 0; i < 16 && b + i < kV; ++i) {
        acc[4 * (b + i)] += v[i].x;
        acc[4 * (b + i) + 1] += v[i].y;
        acc[4 * (b + i) + 2] += v[i].z;
        acc[4 * (b + i) + 3] += v[i].w;
      }
    }
  }
  return true;
}

template <class Op>
__device__ __forceinline__ void produce(const typename Op::Params& p, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty) {
  Walk walk(p.sched);
  Unit u;
  int stage = 0, phase = 0;
  while (walk.next(u)) {
    int tm, tn;
    raster(p.sched, u.tile, tm, tn);
    for (int k = u.kb; k < u.ke; ++k) {
      mbar_wait(&empty[stage], phase ^ 1);  // a fresh barrier passes parity 1
      Op::load(p, smem + stage * Op::kStageBytes, &full[stage], tm, tn, k);
      if (++stage == Op::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

template <class Op>
__device__ __forceinline__ void consume(const typename Op::Params& p, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty, int* last) {
  using L = Layout<Op>;
  constexpr int S = Op::kStages;
  const int wg = threadIdx.x / 128;
  const bool lead = threadIdx.x % 32 == 0;  // releases stages for its warp
  Walk walk(p.sched);
  Unit u;
  int stage = 0, phase = 0;
  // written first by each unit's products (scale-d 0 on its first step):
  // other instructions touch it only after the unit's last wait, or ptxas
  // serializes the products
  typename Op::Acc acc[Op::kAcc];
  while (walk.next(u)) {
    const int n = u.ke - u.kb;
    if constexpr (Op::kTBytes == 0) {
      int prev = 0;
      for (int j = 0; j < n; ++j) {
        mbar_wait(&full[stage], phase);
        wgmma_fence();
        Op::mma(acc, smem + stage * Op::kStageBytes, nullptr, wg, j > 0);
        wgmma_commit();
        wgmma_wait_n<1>();  // the previous panel's products are done: free its stage
        if (j > 0 && lead) mbar_arrive(&empty[prev]);
        __syncwarp();
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait();
      if (lead) mbar_arrive(&empty[prev]);
      __syncwarp();
    } else {
      // W is transposed into one of two panels by the 256 consumer threads,
      // the next panel's under this panel's products; one barrier of the
      // 256 a panel orders the two
      uint8_t* tp = smem + L::kTOff;
      mbar_wait(&full[stage], phase);
      Op::transpose(smem + stage * Op::kStageBytes, tp);
      fence_async_shared();
      named_bar(1, kConsumers);
      for (int j = 0; j < n; ++j) {
        const int cur = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
        wgmma_fence();
        Op::mma(acc, smem + cur * Op::kStageBytes, tp + (j & 1) * Op::kTBytes, wg, j > 0);
        wgmma_commit();
        if (j + 1 < n) {
          mbar_wait(&full[stage], phase);
          Op::transpose(smem + stage * Op::kStageBytes, tp + ((j + 1) & 1) * Op::kTBytes);
        }
        wgmma_wait();
        fence_async_shared();
        named_bar(1, kConsumers);
        if (lead) mbar_arrive(&empty[cur]);
        __syncwarp();
      }
    }
    fence_regs(acc);
    int tm, tn;
    raster(p.sched, u.tile, tm, tn);
    if (u.pieces > 1 && !fixup<Op>(p, acc, u, last)) continue;
    Op::epilogue(p, acc, tm, tn, smem + L::kOutOff + wg * Op::kOutBytes,
                 smem + L::kExtraOff + wg * Op::kExtraBytes);
  }
  if (threadIdx.x % 128 == 0) tma_store_wait_read<0>();  // the stores have read shared memory
}

// The kernel body: a __global__ of the including file, declared
// __launch_bounds__(kThreads, 1), calls it with its __grid_constant__
// parameters, launched with Layout<Op>::kBytes of dynamic shared memory.
template <class Op>
__device__ __forceinline__ void run(const typename Op::Params& p) {
  using L = Layout<Op>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + (kSmemAlign - smem_u32(smem_raw) % kSmemAlign) % kSmemAlign;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + Op::kStages;
  int* last = reinterpret_cast<int*>(empty + Op::kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Op::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kReleases);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<Op::kProducerRegs>();
    if (threadIdx.x == kConsumers) produce<Op>(p, smem, full, empty);
  } else {
    setmaxnreg_inc<Op::kConsumerRegs>();
    consume<Op>(p, smem, full, empty, last);
  }
}

// Two rows' values of a thread in one 8-column group of the tile (its
// column pair in the upper row r0 and in r0 + 8): bf16 pairs or int32 pairs.
template <class T>
struct RowPairs {
  using Pair = typename std::conditional<sizeof(T) == 2, uint32_t, int2>::type;
  Pair r[2];
};

// A consumer warpgroup's 64 rows from row0, kPanels 128-byte panels of T
// (64 bf16 or 32 int32 columns each) from col0, through its staging buffer
// of kBufPanels panels and TMA stores that leave out what lies past (rows,
// cols); pack(c8) gives the thread's RowPairs<T> of 8-column group c8. The
// stores stay in flight; the buffer is written again only after they have
// read it.
template <class T, int kPanels, int kBufPanels, class Pack>
__device__ __forceinline__ void store_tile(const Map& map, uint8_t* buf, int row0, int col0,
                                           int rows, int cols, Pack&& pack) {
  constexpr int kPanelBytes = 64 * kRowBytes;
  constexpr int kCols = kRowBytes / sizeof(T);  // columns of a panel
  const int tid = threadIdx.x % 128;
  const int bar = 2 + threadIdx.x / 128;
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int c = 0; c < kPanels / kBufPanels; ++c) {
    if (tid == 0) tma_store_wait_read<0>();
    named_bar(bar, 128);
#pragma unroll
    for (int pp = 0; pp < kBufPanels; ++pp) {
#pragma unroll
      for (int g = 0; g < kCols / 8; ++g) {
        const RowPairs<T> v = pack((c * kBufPanels + pp) * (kCols / 8) + g);
        const int byte = (8 * g + 2 * t) * (int)sizeof(T);  // of the panel's row
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          *reinterpret_cast<typename RowPairs<T>::Pair*>(
              buf + pp * kPanelBytes + row * kRowBytes + (((byte >> 4) ^ (row & 7)) << 4) +
              (byte & 15)) = v.r[r];
        }
      }
    }
    fence_async_shared();
    named_bar(bar, 128);
    if (tid == 0 && row0 < rows) {
      for (int pp = 0; pp < kBufPanels; ++pp) {
        const int col = col0 + (c * kBufPanels + pp) * kCols;
        if (col < cols) tma_store(map, buf + pp * kPanelBytes, col, 0, row0, 0);
      }
      tma_store_commit();
    }
  }
}

// ---- host: the schedule ----------------------------------------------------

// Costs in panels of the tile, fitted to the split and unsplit times of
// P1 and K5 on an H100 (PERF.md section 6): a unit's epilogue, a split tile's
// partial stores, count and sum (~10 us on the card: the partials move
// through L2 and, where W streams from device memory once, add to its
// bytes), and the share of the whole-tile cost a split must beat.
constexpr double kTileCost = 1.0;
constexpr double kSplitCost = 20.0;
constexpr double kSplitGain = 0.9;

// The schedule of tiles_m x tiles_n tiles of nk panels on sms SMs, and its
// cost in panels (the slowest CTA's): all tiles whole, or the whole waves
// but the last one or two and the rest cut into 2 to kMaxChunks chunks,
// whichever is cheaper.
inline Sched plan(int tiles_m, int tiles_n, int nk, int sms, double* cost) {
  const long long tiles = (long long)tiles_m * tiles_n;
  Sched best{tiles_m, tiles_n, nk, (int)std::min<long long>(tiles, sms), (int)tiles, 0, 0};
  const double whole = (double)((tiles + sms - 1) / sms) * (nk + kTileCost);
  *cost = whole;
  for (long long waves = tiles / sms; waves >= 0 && waves + 1 >= tiles / sms; --waves) {
    const long long sk = tiles - waves * sms;
    if (sk == 0 || sk > kMaxCounters) continue;
    for (int chunks = 2; chunks <= std::min(nk, kMaxChunks); ++chunks) {
      const long long rounds = (sk * chunks + sms - 1) / sms;
      const double c =
          waves * (nk + kTileCost) + rounds * ((nk + chunks - 1) / chunks + kTileCost) + kSplitCost;
      if (c < kSplitGain * whole && c < *cost) {
        *cost = c;
        best.dp_tiles = (int)(waves * sms);
        best.sk_tiles = (int)sk;
        best.chunks = chunks;
        best.grid = (int)std::min<long long>(sms, best.dp_tiles + sk * chunks);
      }
    }
  }
  return best;
}

// Bytes of workspace the schedule's split tiles take (acc registers a
// consumer thread, of 4 bytes).
inline long long workspace_bytes(const Sched& s, int acc_regs) {
  return (long long)s.sk_tiles * s.chunks * kConsumers * acc_regs * 4;
}

// The schedule as the wrappers report it: {tile columns, tiles_m, tiles_n,
// nk, grid, dp_tiles, sk_tiles, chunks}.
inline void describe(const Sched& s, int bn, long long* info) {
  const long long v[8] = {bn, s.tiles_m, s.tiles_n, s.nk, s.grid, s.dp_tiles, s.sk_tiles,
                          s.chunks};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
}

}  // namespace gemm
}  // namespace sm90

// K3: backward of K1 (fused self-attention on the packed (B, S, H*D) layout),
// bf16 in and out, fp32 accumulation.
//
// Replaces the TPU kernel `_attn_bwd_kernel` (imagharmony_tpu/kernels/
// flash_attention.py:220), reached through `_flash_bwd_impl` (:270) from the
// packed layout's custom_vjp backward `_flash_nhd_bwd` (:540). The Pallas
// kernel relayouts to (B, H, S, D) and recomputes a no-max softmax clamped at
// exp(80); this one stays in the packed layout and recomputes the exact
// softmax from the row log-sum-exp that K1 writes (`lse`, scaled-log2
// domain: lse = m + log2(l) with m the row max of s = q.k*scale*log2(e) and
// l = sum exp2(s - m)), so P = exp2(s - lse) needs no running max here.
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
// Design (simple and correct first; wgmma/TMA are later work). Three kernels,
// no atomics, so the gradients are deterministic:
//   1. delta_kernel: Delta = rowsum(dO o O) in fp32, one thread per (row, head).
//   2. dkdv_kernel: one CTA of 4 warps per (64-key tile, head, batch). Each
//      warp keeps its 16 keys' K and V as mma A-fragments in registers and
//      its dK/dV rows in fp32 registers, and loops over 64-row query tiles:
//      S^T = K Qs^T, P^T = exp2(S^T - lse), dP^T = V dO^T,
//      dS^T = P^T o (dP^T - Delta), dV += P^T dO, dK += dS^T Q.
//   3. dq_kernel: one CTA per (64-row query tile, head, batch), each warp 16
//      query rows with Qs and dO as A-fragments; it loops over 64-key tiles:
//      S = Qs K^T, P, dP = dO V^T, dS, dQ += dS K.
// Qs = bf16(q * scale*log2(e)), rounded exactly as K1 rounds it, so P here is
// the P of the forward. Products are mma.sync.m16n8k16 bf16 with fp32
// accumulation; P and dS are rounded to bf16 as mma operands. The
// accumulator layout of one product is the A-operand layout of the next, so
// P and dS never leave registers; B operands that a product needs with the
// other axis contiguous are staged transposed in shared memory.
// q, k, v, o and dO take a row and a batch stride each (column views of a
// packed projection need no copy); dq, dk, dv are contiguous (B, S, H*D).
// Ragged edges are masked here: keys past Sk get P = 0, query rows past Sq
// get lse = +inf (so P = 0) and Delta = 0, and nothing past either edge is
// stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per tile
constexpr int kBlockN = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 elements of row padding (bank spread)

typedef __nv_bfloat16 bf16;

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

// 16-byte chunk c of row (row0 + r) of one head, or zeros past n_rows.
__device__ __forceinline__ uint4 load_chunk(const bf16* src, int64_t row_stride, int row0, int r,
                                            int c, int n_rows) {
  if (row0 + r < n_rows) {
    return *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + c);
  }
  return make_uint4(0u, 0u, 0u, 0u);
}

// (64, D) tile of rows [row0, row0+64) into shared memory, row pitch D + kPad.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t row_stride,
                                          int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) =
        load_chunk(src, row_stride, row0, r, c, n_rows);
  }
}

// As load_rows, each element times `mul` and rounded to bf16: K1's Qs.
template <int D>
__device__ __forceinline__ void load_rows_scaled(bf16* dst, const bf16* src, int64_t row_stride,
                                                 int row0, int n_rows, float mul) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = load_chunk(src, row_stride, row0, r, c, n_rows);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = pack_bf16(__bfloat162float(e[2 * j]) * mul, __bfloat162float(e[2 * j + 1]) * mul);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) = out;
  }
}

// The same tile stored transposed: dst[d][row], pitch 64 + kPad.
template <int D>
__device__ __forceinline__ void load_rows_t(bf16* dst, const bf16* src, int64_t row_stride,
                                            int row0, int n_rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = load_chunk(src, row_stride, row0, r, c, n_rows);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * (64 + kPad) + r] = e[j];
  }
}

// mma A-fragments of the 16-row slab [row0, row0+16) of a row-major shared
// tile (pitch D + kPad), for a product over the D axis.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const bf16* tile,
                                             int row0, int g, int t) {
  const bf16* p0 = tile + (row0 + g) * (D + kPad);
  const bf16* p1 = p0 + 8 * (D + kPad);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c0 = kk * 16 + 2 * t;
    f[kk][0] = ld32(p0 + c0);
    f[kk][1] = ld32(p1 + c0);
    f[kk][2] = ld32(p0 + c0 + 8);
    f[kk][3] = ld32(p1 + c0 + 8);
  }
}

// acc[nb] (16 x 8 per n-block, 64 columns) += A (16 x D) . rows(tile)^T,
// where tile is row-major (64 rows, pitch D + kPad): a product over D.
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* tile, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;
    const bf16* row = tile + (nb * 8 + g) * (D + kPad);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_bf16_16816(acc[nb], a[kk], ld32(row + kk * 16 + 2 * t), ld32(row + kk * 16 + 8 + 2 * t));
    }
  }
}

// out[nd] (16 x D) += X (16 x 64, in accumulator layout, rounded to bf16
// here) . tile_t^T, where tile_t is a transposed tile (D rows of 64, pitch
// 64 + kPad): a product over the 64-wide axis.
template <int D>
__device__ __forceinline__ void mma_cols(float (&out)[D / 8][4], const float (&x)[8][4],
                                         const bf16* tile_t, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t xf[4];
    xf[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    xf[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    xf[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xf[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const bf16* col = tile_t + (nd * 8 + g) * (64 + kPad) + kk * 16;
      mma_bf16_16816(out[nd], xf, ld32(col + 2 * t), ld32(col + 8 + 2 * t));
    }
  }
}

// Rows [row0, row0+16) of a warp's (16 x D) accumulator, times `mul`, into a
// contiguous (B, S, H*D) bf16 tensor; rows >= n_rows are not stored.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], float mul,
                                           int b, int h, int heads, int n_rows, int row0, int g,
                                           int t) {
  const int64_t hd = (int64_t)heads * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    bf16* out = dst + ((int64_t)b * n_rows + row) * hd + (int64_t)h * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(out + nd * 8 + 2 * t) =
          pack_bf16(acc[nd][2 * r] * mul, acc[nd][2 * r + 1] * mul);
    }
  }
}

template <int D>
__global__ void delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                             float* __restrict__ delta, int sq, int heads, int64_t o_row,
                             int64_t do_row, int64_t o_batch, int64_t do_batch, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int h = (int)(i % heads);
  const int64_t rest = i / heads;
  const int row = (int)(rest % sq);
  const int b = (int)(rest / sq);
  const bf16* op = o + b * o_batch + row * o_row + (int64_t)h * D;
  const bf16* dp = dout + b * do_batch + row * do_row + (int64_t)h * D;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    uint4 a = *reinterpret_cast<const uint4*>(op + c);
    uint4 d = *reinterpret_cast<const uint4*>(dp + c);
    const bf16* ea = reinterpret_cast<const bf16*>(&a);
    const bf16* ed = reinterpret_cast<const bf16*>(&d);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += __bfloat162float(ea[j]) * __bfloat162float(ed[j]);
  }
  delta[((int64_t)b * heads + h) * sq + row] = acc;
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int sq, sk, heads;
  int64_t q_row, k_row, v_row, do_row;
  int64_t q_batch, k_batch, v_batch, do_batch;
  float scale, scale_log2;
};

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  __shared__ __align__(16) bf16 sQs[kBlockM * (D + kPad)];   // staging for K first
  __shared__ __align__(16) bf16 sdO[kBlockM * (D + kPad)];   // staging for V first
  __shared__ __align__(16) bf16 sQt[D * (kBlockM + kPad)];
  __shared__ __align__(16) bf16 sdOt[D * (kBlockM + kPad)];
  __shared__ float sLse[kBlockM];
  __shared__ float sDelta[kBlockM];

  const int n0 = blockIdx.x * kBlockN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const bf16* qh = a.q + b * a.q_batch + (int64_t)h * D;
  const bf16* kh = a.k + b * a.k_batch + (int64_t)h * D;
  const bf16* vh = a.v + b * a.v_batch + (int64_t)h * D;
  const bf16* doh = a.dout + b * a.do_batch + (int64_t)h * D;
  const int64_t stat0 = ((int64_t)b * a.heads + h) * a.sq;

  // this warp's 16 keys of K and V as A-fragments
  load_rows<D>(sQs, kh, a.k_row, n0, a.sk);
  load_rows<D>(sdO, vh, a.v_row, n0, a.sk);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags<D>(kf, sQs, warp * 16, g, t);
  load_a_frags<D>(vf, sdO, warp * 16, g, t);
  __syncthreads();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nd][i] = dv_acc[nd][i] = 0.f;
  const int key0 = n0 + warp * 16 + g;  // keys of rows g and g + 8

  for (int m0 = 0; m0 < a.sq; m0 += kBlockM) {
    load_rows_scaled<D>(sQs, qh, a.q_row, m0, a.sq, a.scale_log2);
    load_rows_t<D>(sQt, qh, a.q_row, m0, a.sq);
    load_rows<D>(sdO, doh, a.do_row, m0, a.sq);
    load_rows_t<D>(sdOt, doh, a.do_row, m0, a.sq);
    for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
      const bool valid = m0 + i < a.sq;
      sLse[i] = valid ? a.lse[stat0 + m0 + i] : INFINITY;
      sDelta[i] = valid ? a.delta[stat0 + m0 + i] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_rows<D>(s, kf, sQs, g, t);   // S^T (keys x queries), log2 domain
    mma_rows<D>(dp, vf, sdO, g, t);  // dP^T
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nb * 8 + 2 * t + (i & 1);
        const int key = key0 + 8 * (i >> 1);
        const float p = key < a.sk ? exp2f(s[nb][i] - sLse[col]) : 0.f;
        s[nb][i] = p;
        dp[nb][i] = p * (dp[nb][i] - sDelta[col]);
      }
    }
    mma_cols<D>(dv_acc, s, sdOt, g, t);   // dV += P^T dO
    mma_cols<D>(dk_acc, dp, sQt, g, t);   // dK += dS^T Q
    __syncthreads();  // before the next tile overwrites shared memory
  }

  store_rows<D>(a.dk, dk_acc, a.scale, b, h, a.heads, a.sk, n0 + warp * 16, g, t);
  store_rows<D>(a.dv, dv_acc, 1.f, b, h, a.heads, a.sk, n0 + warp * 16, g, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  __shared__ __align__(16) bf16 sK[kBlockN * (D + kPad)];   // staging for Qs first
  __shared__ __align__(16) bf16 sV[kBlockN * (D + kPad)];   // staging for dO first
  __shared__ __align__(16) bf16 sKt[D * (kBlockN + kPad)];

  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const bf16* qh = a.q + b * a.q_batch + (int64_t)h * D;
  const bf16* kh = a.k + b * a.k_batch + (int64_t)h * D;
  const bf16* vh = a.v + b * a.v_batch + (int64_t)h * D;
  const bf16* doh = a.dout + b * a.do_batch + (int64_t)h * D;
  const int64_t stat0 = ((int64_t)b * a.heads + h) * a.sq;

  load_rows_scaled<D>(sK, qh, a.q_row, m0, a.sq, a.scale_log2);
  load_rows<D>(sV, doh, a.do_row, m0, a.sq);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_frags<D>(qf, sK, warp * 16, g, t);
  load_a_frags<D>(dof, sV, warp * 16, g, t);
  __syncthreads();

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    lse_r[r] = row < a.sq ? a.lse[stat0 + row] : INFINITY;
    delta_r[r] = row < a.sq ? a.delta[stat0 + row] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq_acc[nd][i] = 0.f;

  for (int n0 = 0; n0 < a.sk; n0 += kBlockN) {
    load_rows<D>(sK, kh, a.k_row, n0, a.sk);
    load_rows<D>(sV, vh, a.v_row, n0, a.sk);
    load_rows_t<D>(sKt, kh, a.k_row, n0, a.sk);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_rows<D>(s, qf, sK, g, t);    // S (queries x keys), log2 domain
    mma_rows<D>(dp, dof, sV, g, t);  // dP
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nb * 8 + 2 * t + (i & 1);
        const int r = i >> 1;
        const float p = col < a.sk ? exp2f(s[nb][i] - lse_r[r]) : 0.f;
        s[nb][i] = p * (dp[nb][i] - delta_r[r]);  // dS
      }
    }
    mma_cols<D>(dq_acc, s, sKt, g, t);  // dQ += dS K
    __syncthreads();
  }

  store_rows<D>(a.dq, dq_acc, a.scale, b, h, a.heads, a.sq, m0 + warp * 16, g, t);
}

template <int D>
int launch(const Args& a, const bf16* o, int64_t o_row, int64_t o_batch, float* delta,
           int batch, cudaStream_t stream) {
  const int64_t total = (int64_t)batch * a.sq * a.heads;
  const int threads = 256;
  delta_kernel<D><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      o, a.dout, delta, a.sq, a.heads, o_row, a.do_row, o_batch, a.do_batch, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<D><<<dim3((a.sk + kBlockN - 1) / kBlockN, a.heads, batch), kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<D><<<dim3((a.sq + kBlockM - 1) / kBlockM, a.heads, batch), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Strides are in elements; `delta`
// is fp32 scratch of B*H*Sq elements that the caller allocates; dq, dk, dv
// are contiguous. Returns the first CUDA error of the three launches (0 on
// success); an unsupported head_dim or an empty shape returns
// cudaErrorInvalidValue without launching.
extern "C" int flash_attn_nhd_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int sq, int sk,
    int heads, int head_dim, long long q_row, long long k_row, long long v_row, long long o_row,
    long long do_row, long long q_batch, long long k_batch, long long v_batch, long long o_batch,
    long long do_batch, float scale, float scale_log2, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.sq = sq;
  a.sk = sk;
  a.heads = heads;
  a.q_row = q_row;
  a.k_row = k_row;
  a.v_row = v_row;
  a.do_row = do_row;
  a.q_batch = q_batch;
  a.k_batch = k_batch;
  a.v_batch = v_batch;
  a.do_batch = do_batch;
  a.scale = scale;
  a.scale_log2 = scale_log2;
  const bf16* ob = static_cast<const bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(a, ob, o_row, o_batch, delta, batch, s);
    case 64:
      return launch<64>(a, ob, o_row, o_batch, delta, batch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

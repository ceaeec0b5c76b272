// K7: one whole TransformerLM decode step, every layer, in ONE cooperative
// launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel_mega` of
// speech_anonymization_tpu/ops/pallas/lm_megastep.py (launched by
// `_lm_megastep_call`). For a fused-KV paged cache (csrc/attention_step.cu's
// layout at page 64: kv (L, N, 2U, M), kv_act (L, N, 2, 128, M), table
// (N, U / 64), act_src (N,)) and each layer l in order:
//
//   q, k, v = bf16(bf16(x) @ Wq + bq), ... (the same for k and v)
//   c       = attention of q over the row's logical cache at `step`, the
//             fresh k/v at `step` (K6's body: csrc/attention_step.cuh), which
//             also writes the merged active page of layer l in place
//   x       = LN1(x + (bf16(c) @ Wo + bo))
//   h       = bf16(gelu(bf16(x) @ W1 + b1))              (N, d_ffn)
//   x       = LN2(x + (h @ W2 + b2))
//
// with x0 (N, M) f32 in and x (N, M) f32 out. LN is flax's: mean, fast
// variance max(E[x^2] - E[x]^2, 0), (x - mean) * rsqrt(var + 1e-6) * scale +
// bias. gelu is the tanh approximation, or erf with kExact (sb_compat LMs).
// Weights, from prepare_lm_megastep: wall (L * NB, M, M) bf16 blocks in flax's
// (in, out) layout, [q, k, v, o, w1_c0, w2_c0, ..., w1_c(nf-1), w2_c(nf-1)]
// per layer (NB = 4 + 2 nf, nf = d_ffn / M: block w1_c holds columns
// c M .. (c + 1) M - 1 of W1, w2_c the same rows of W2); vecs (L, 9 + nf, M)
// f32 rows [bq, bk, bv, bo, b1 (nf rows), b2, ln1 scale, ln1 bias, ln2 scale,
// ln2 bias].
//
// Numerics: the TPU kernel's serving numerics. bf16 weights; x rounded to
// bf16 before each projection, q/k/v rounded to bf16, the attention output
// rounded to bf16 before the out-projection, the FF hidden rounded to bf16
// before W2; every product bf16 x bf16 with f32 accumulation; residuals and
// LayerNorms in f32. The fresh k/v written to the cache are the bf16-rounded
// values, in an f32 cache too, so a cache that only K7 wrote holds
// bf16-representable k/v. The attention is K6's arithmetic, bit for bit, on
// those operands: f32 products and sums (the TPU kernel's bf16 rounding of
// per-element q.k products is a concession to its matrix unit, and is not
// kept). f32 and bf16 caches; int8 is refused by the wrapper.
//
// Bound: at the D2 decode shape (N 528, U 256, M 768, 12 layers, d_ffn 3072)
// a step must read 12 layers' live cache (the positions its rows hold valid,
// each distinct page once, ~320 MB a layer in f32 mid-decode), write each
// row's merged active page, and read 170 MB of bf16 weights: ~4 GB, ~1.2 ms
// at 3.35 TB/s. Its 89.7 GFLOP of products take 0.09 ms at the bf16 tensor
// cores' peak. So it is bound by device-memory bytes, mostly the cache's.
//
// Design: the TPU kernel is one grid step on one core walking all N rows in
// VMEM; its point is one dispatch for a whole LM step, the layers' matmuls
// overlapping the weight streams. Here that becomes one persistent
// cooperative launch: a grid of as many 128-thread blocks as the card holds
// at once (cudaLaunchCooperativeKernel guarantees they are co-resident), and
// each layer as seven phases separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()), each phase a loop of its work
// items over the blocks:
//   1. q/k/v: 64 x 64 output tiles of the three projections;
//   2. attention: one item per (row, head), K6's device body;
//   3. out-projection in two K-slices, each tile's f32 sum to scratch;
//   4. sum of the slices + bias + residual, LayerNorm 1 (a warp a row);
//   5. W1 + bias + gelu into an (N, d_ffn) bf16 hidden buffer (3.2 MB at D2,
//      it stays in L2);
//   6. W2 in nf K-slices (its row blocks), each tile's f32 sum to scratch;
//   7. sum of the slices + bias + residual, LayerNorm 2.
// The K-slices give the grid 2x and nf x the out-projection's and W2's few
// 64 x 64 tiles (108 at D2 for ~530 blocks); their sums are added in a fixed
// order, so a launch is deterministic.
// A product tile is four warps of nvcuda::wmma 16x16x16 bf16 fragments (each
// warp 32 x 32) over K in stages of 32, staged through shared memory by plain
// 16-byte loads (f32 activations are rounded to bf16 as they are staged); the
// next stage's loads are in flight in registers during a stage's products.
// Intermediate activations live in global scratch that the wrapper allocates
// (x, q/k/v, attention output, K-slice sums, hidden; ~17 MB at D2, in L2).
// wgmma, TMA and overlapping the weight stream with the attention are later
// work. Limits checked by the Python wrapper: M a multiple of 64, d_ffn a
// multiple of M, K6's head-width and alignment limits, page 64.

#include <cooperative_groups.h>
#include <mma.h>

#include "attention_step.cuh"

#ifdef SA_LM_MEGA_STAMPS
// The build of tools/profile_lm_megastep.py: block 0 reads the card's global
// timer at the start and after every grid barrier (7 a layer).
constexpr int kStamps = 1024;
__device__ unsigned long long stamps[kStamps];
__device__ __forceinline__ void stamp(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && i < kStamps) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;         // output rows and columns of a product tile
constexpr int kDepth = 32;        // K per shared-memory stage
constexpr int kLdA = kDepth + 8;  // padded leading dimensions (elements)
constexpr int kLdB = kTile + 8;
constexpr int kLdC = kTile + 4;
constexpr size_t kGemmSmem =
    (kTile * kLdA + kDepth * kLdB) * sizeof(bf16) + kTile * kLdC * sizeof(float);
constexpr int kPageShift = 6;  // page 64
constexpr float kLnEps = 1e-6f;

// The operands of one launch.
template <typename T>
struct Mega {
  const float* x0;            // (n, m)
  const unsigned char* mask;  // (n, u), nonzero = valid key
  T* kv;                      // (layers, n, 2u, m)
  T* kv_act;                  // (layers, n, 2, 128, m)
  const int* table;           // (n, u / 64)
  const int* act_src;         // (n,)
  const bf16* wall;           // (layers * nb, m, m)
  const float* vecs;          // (layers, nv, m)
  float* xs;                  // (n, m): x after each layer; the output
  float* qkv;                 // (3, n, m): bf16-valued q, k, v
  float* ctx;                 // (n, m): the attention output
  float* part;                // (max(nf, kOutSlices), n, m): K-slice sums of a product
  bf16* hid;                  // (n, d_ffn): the FF hidden
  int n, u, m, nhead, layers, d_ffn, step;
};

__device__ __forceinline__ float to_bf16(float x) { return round_to<bf16>(x); }

template <bool kExact>
__device__ __forceinline__ float gelu(float x) {
  if constexpr (kExact) {
    return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  } else {
    return 0.5f * x * (1.f + tanhf(0.79788456080286536f * (x + 0.044715f * x * x * x)));
  }
}

// 16 consecutive operand elements held in registers between their load and
// their store to shared memory as bf16 (f32 activations are rounded there).
template <typename TA>
struct Stage16;
template <>
struct Stage16<float> {
  float4 v[4];
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = reinterpret_cast<const float4*>(p)[i];
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void store(bf16* dst) const {  // 16-byte aligned
    uint4 w[2];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[2 * i] = __floats2bfloat162_rn(v[i].x, v[i].y);
      h[2 * i + 1] = __floats2bfloat162_rn(v[i].z, v[i].w);
    }
    reinterpret_cast<uint4*>(dst)[0] = w[0];
    reinterpret_cast<uint4*>(dst)[1] = w[1];
  }
};
template <>
struct Stage16<bf16> {
  uint4 v[2];
  __device__ __forceinline__ void load(const bf16* p) {
    v[0] = reinterpret_cast<const uint4*>(p)[0];
    v[1] = reinterpret_cast<const uint4*>(p)[1];
  }
  __device__ __forceinline__ void zero() { v[0] = v[1] = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void store(bf16* dst) const {
    reinterpret_cast<uint4*>(dst)[0] = v[0];
    reinterpret_cast<uint4*>(dst)[1] = v[1];
  }
};

// One 64 x 64 output tile: rows r0 .. r0 + 63 (those below n) of A (n, K)
// with row stride lda, times the bf16 (K, 64) panel whose row k starts at
// b_row(k) (row stride irrelevant: each row is addressed). epi(row, col, acc)
// receives every f32 sum of the tile, col within the tile. All threads of the
// block call it; it ends with a barrier, so shared memory is free afterwards.
// The next stage's loads are issued into registers before the current
// stage's products, so their latency overlaps the tensor-core work.
template <typename TA, typename BRow, typename Epi>
__device__ __forceinline__ void gemm_tile(const TA* A, int lda, int n, int r0, int K, BRow b_row,
                                          unsigned char* smem, Epi epi) {
  using namespace nvcuda;
  bf16* as = reinterpret_cast<bf16*>(smem);  // [kTile][kLdA]
  bf16* bs = as + kTile * kLdA;              // [kDepth][kLdB]
  float* cs = reinterpret_cast<float*>(bs + kDepth * kLdB);  // [kTile][kLdC]
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  const int ar = threadIdx.x >> 1, ac = (threadIdx.x & 1) * 16;  // A: 64 rows x 2 halves
  const int br = threadIdx.x >> 2, bc = (threadIdx.x & 3) * 16;  // B: 32 rows x 4 quarters
  const bool a_live = r0 + ar < n;
  const TA* a_row = A + static_cast<size_t>(a_live ? r0 + ar : 0) * lda + ac;
  Stage16<TA> sa;
  Stage16<bf16> sb;
  if (a_live) {
    sa.load(a_row);
  } else {
    sa.zero();
  }
  sb.load(b_row(br) + bc);
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    sa.store(as + ar * kLdA + ac);
    sb.store(bs + br * kLdB + bc);
    __syncthreads();
    if (k0 + kDepth < K) {  // the next stage, in flight during this one's products
      if (a_live) sa.load(a_row + k0 + kDepth);
      sb.load(b_row(k0 + kDepth + br) + bc);
    }
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], as + (wr + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], bs + kk * kLdB + wc + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs + (wr + 16 * i) * kLdC + wc + 16 * j, acc[i][j], kLdC,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile, c = idx % kTile;
    if (r0 + r < n) epi(r0 + r, c, cs[r * kLdC + c]);
  }
  __syncthreads();
}

// For every row, one warp a row: out = LN(resid + (part[0] + ... +
// part[parts - 1] + pbias)), the product's K-slices summed in order. out may
// be resid: each lane reads and writes only its own elements.
__device__ __forceinline__ void add_norm_rows(const float* part, int parts, const float* pbias,
                                              const float* resid, const float* scale,
                                              const float* bias, float* out, int n, int m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t nm = static_cast<size_t>(n) * m;
  for (int r = blockIdx.x * kWarps + warp; r < n; r += gridDim.x * kWarps) {
    const size_t row = static_cast<size_t>(r) * m;
    float* y = out + row;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < m; c += 32) {
      float prod = part[row + c];
      for (int k = 1; k < parts; ++k) prod += part[k * nm + row + c];
      const float v = resid[row + c] + (prod + pbias[c]);
      y[c] = v;
      s += v;
      s2 = fmaf(v, v, s2);
    }
    const float mu = warp_sum(s) / m;
    const float var = fmaxf(warp_sum(s2) / m - mu * mu, 0.f);
    const float rs = rsqrtf(var + kLnEps);
    for (int c = lane; c < m; c += 32) y[c] = (y[c] - mu) * rs * scale[c] + bias[c];
  }
}

// The out-projection's K-slices (K = M): more work items for the grid.
constexpr int kOutSlices = 2;

// At least kMinBlocks blocks an SM, which caps the registers at 128 a
// thread. The products want registers and the attention wants warps in
// flight: at D2's LM step on an H100 SXM (700 W), 6 blocks (80 registers)
// spill and run the products ~1.9x slower, 3 blocks (~166 registers) run the
// attention ~1.2x slower than 4 does, and 4 gives the fastest step of 3-6.
constexpr int kMinBlocks = 4;

template <typename T, bool kExact>
__global__ void __launch_bounds__(kThreads, kMinBlocks) lm_mega(const Mega<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  int passed = 0;  // grid barriers passed, for the stamped build's timer reads
  const auto barrier = [&] {
    grid.sync();
    stamp(++passed);
  };
  stamp(0);
  const int n = p.n, m = p.m;
  const size_t nm = static_cast<size_t>(n) * m, mm = static_cast<size_t>(m) * m;
  const int nf = p.d_ffn / m, nb = 4 + 2 * nf, nv = 9 + nf;
  const int tiles_r = (n + kTile - 1) / kTile, tiles_m = m / kTile;
  const int d_head = m / p.nhead;

  Args<T> a = {};
  a.q = p.qkv;
  a.kh = p.qkv + nm;
  a.vh = p.qkv + 2 * nm;
  a.mask = p.mask;
  a.ck = a.cv = p.kv;
  a.ak = a.av = p.kv_act;
  a.table = p.table;
  a.act_src = p.act_src;
  a.out = p.ctx;
  a.n = n;
  a.u = p.u;
  a.m = m;
  a.d_head = d_head;
  a.step = p.step;
  a.page_shift = kPageShift;
  a.row_pos = 2 * p.u;
  a.page_pos = 2 << kPageShift;
  a.slot_pos = 2 << kPageShift;
  a.v_off = 1 << kPageShift;
  a.scale = sqrtf(static_cast<float>(d_head));

  for (int l = 0; l < p.layers; ++l) {
    const float* xin = l == 0 ? p.x0 : p.xs;
    const bf16* wl = p.wall + static_cast<size_t>(l) * nb * mm;
    const float* vec = p.vecs + static_cast<size_t>(l) * nv * m;

    // 1. q, k, v = bf16(bf16(x) @ W + b)
    for (int t = blockIdx.x; t < 3 * tiles_r * tiles_m; t += gridDim.x) {
      const int j = t / (tiles_r * tiles_m), rest = t % (tiles_r * tiles_m);
      const int r0 = rest / tiles_m * kTile, c0 = rest % tiles_m * kTile;
      const bf16* w = wl + j * mm + c0;
      const float* b = vec + j * m + c0;
      float* out = p.qkv + j * nm + c0;
      gemm_tile(xin, m, n, r0, m, [&](int k) { return w + static_cast<size_t>(k) * m; }, smem,
                [&](int r, int c, float s) { out[static_cast<size_t>(r) * m + c] = to_bf16(s + b[c]); });
    }
    barrier();

    // 2. attention over the paged cache; writes ctx and the merged pages
    a.layer = l;
    for (int item = blockIdx.x; item < n * p.nhead; item += gridDim.x) {
      attn_step_chunked_item<T, true>(a, item, reinterpret_cast<float*>(smem));
      __syncthreads();
    }
    barrier();

    // 3. part[s] = bf16(ctx)[:, slice s] @ Wo[slice s, :], kOutSlices K-slices
    const int ks = m / kOutSlices;
    for (int t = blockIdx.x; t < kOutSlices * tiles_r * tiles_m; t += gridDim.x) {
      const int s = t / (tiles_r * tiles_m), rest = t % (tiles_r * tiles_m);
      const int r0 = rest / tiles_m * kTile, c0 = rest % tiles_m * kTile;
      const bf16* w = wl + 3 * mm + static_cast<size_t>(s) * ks * m + c0;
      float* out = p.part + s * nm + c0;
      gemm_tile(p.ctx + s * ks, m, n, r0, ks, [&](int k) { return w + static_cast<size_t>(k) * m; },
                smem, [&](int r, int c, float acc) { out[static_cast<size_t>(r) * m + c] = acc; });
    }
    barrier();

    // 4. x = LN1(x + (part[0] + part[1] + bo))
    add_norm_rows(p.part, kOutSlices, vec + 3 * m, xin, vec + (5 + nf) * m, vec + (6 + nf) * m, p.xs,
                  n, m);
    barrier();

    // 5. hid = bf16(gelu(bf16(x) @ W1 + b1)), W1's column block c in wall block 4 + 2c
    const int tiles_f = p.d_ffn / kTile;
    for (int t = blockIdx.x; t < tiles_r * tiles_f; t += gridDim.x) {
      const int r0 = t / tiles_f * kTile, c0 = t % tiles_f * kTile;
      const bf16* w = wl + (4 + 2 * (c0 / m)) * mm + c0 % m;
      const float* b = vec + 4 * m + c0;  // the nf b1 rows are b1, contiguous
      gemm_tile(p.xs, m, n, r0, m, [&](int k) { return w + static_cast<size_t>(k) * m; }, smem,
                [&](int r, int c, float s) {
                  p.hid[static_cast<size_t>(r) * p.d_ffn + c0 + c] =
                      __float2bfloat16_rn(gelu<kExact>(s + b[c]));
                });
    }
    barrier();

    // 6. part[c] = hid[:, block c] @ W2[block c, :], W2's row block c in wall
    // block 5 + 2c: nf K-slices
    for (int t = blockIdx.x; t < nf * tiles_r * tiles_m; t += gridDim.x) {
      const int c = t / (tiles_r * tiles_m), rest = t % (tiles_r * tiles_m);
      const int r0 = rest / tiles_m * kTile, c0 = rest % tiles_m * kTile;
      const bf16* w = wl + (5 + 2 * c) * mm + c0;
      float* out = p.part + c * nm + c0;
      gemm_tile(p.hid + static_cast<size_t>(c) * m, p.d_ffn, n, r0, m,
                [&](int k) { return w + static_cast<size_t>(k) * m; }, smem,
                [&](int r, int col, float acc) { out[static_cast<size_t>(r) * m + col] = acc; });
    }
    barrier();

    // 7. x = LN2(x + (part[0] + ... + part[nf - 1] + b2))
    add_norm_rows(p.part, nf, vec + (4 + nf) * m, p.xs, vec + (7 + nf) * m, vec + (8 + nf) * m, p.xs,
                  n, m);
    barrier();
  }
}

int use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

template <typename T, bool kExact>
int launch(const Mega<T>& p, int device, cudaStream_t stream) {
  const auto kernel = lm_mega<T, kExact>;
  const int d_head = p.m / p.nhead;
  const int groups = kThreads / (d_head / Vec<T>::kN);
  const size_t attn = (static_cast<size_t>(kChunk) + kWarps + static_cast<size_t>(groups) * d_head) *
                          sizeof(float) +
                      static_cast<size_t>(p.u >> kPageShift) * sizeof(int);
  const size_t smem = attn > kGemmSmem ? attn : kGemmSmem;
  if (smem > kDefaultSmem) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // every block co-resident: the grid-wide barriers need it
  void* args[] = {const_cast<Mega<T>*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(sms * per_sm),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* x0, const void* mask, void* kv, void* kv_act, const void* table,
                 const void* act_src, const void* wall, const void* vecs, void* xs, void* qkv,
                 void* ctx, void* part, void* hid, int n, int u, int m, int nhead, int layers,
                 int d_ffn, int step, int exact_gelu, int device, cudaStream_t stream) {
  Mega<T> p = {};
  p.x0 = static_cast<const float*>(x0);
  p.mask = static_cast<const unsigned char*>(mask);
  p.kv = static_cast<T*>(kv);
  p.kv_act = static_cast<T*>(kv_act);
  p.table = static_cast<const int*>(table);
  p.act_src = static_cast<const int*>(act_src);
  p.wall = static_cast<const bf16*>(wall);
  p.vecs = static_cast<const float*>(vecs);
  p.xs = static_cast<float*>(xs);
  p.qkv = static_cast<float*>(qkv);
  p.ctx = static_cast<float*>(ctx);
  p.part = static_cast<float*>(part);
  p.hid = static_cast<bf16*>(hid);
  p.n = n;
  p.u = u;
  p.m = m;
  p.nhead = nhead;
  p.layers = layers;
  p.d_ffn = d_ffn;
  p.step = step;
  if (n == 0) return 0;
  return exact_gelu ? launch<T, true>(p, device, stream) : launch<T, false>(p, device, stream);
}

}  // namespace

extern "C" {

// One TransformerLM decode step. x0: (n, m) f32; mask: (n, u) bytes,
// nonzero = valid key; kv: (layers, n, 2u, m) and kv_act (layers, n, 2, 128,
// m), f32 (dtype 0) or bf16 (dtype 1); table: (n, u / 64) int32; act_src:
// (n,) int32; wall: (layers * (4 + 2 d_ffn / m), m, m) bf16; vecs: (layers,
// 9 + d_ffn / m, m) f32. Scratch the caller allocates: xs, ctx (n, m) f32, qkv
// (3, n, m) f32, part (max(d_ffn / m, 2), n, m) f32, hid (n, d_ffn) bf16. Writes x_out into xs and every
// layer's merged active page (slot step % 2, or main page step / 64 when it
// completes). All contiguous on `device`. One cooperative launch on `stream`;
// returns its cudaError_t (0 on success). Does not synchronise.
int sa_lm_megastep(const void* x0, const void* mask, void* kv, void* kv_act, const void* table,
                   const void* act_src, const void* wall, const void* vecs, void* xs, void* qkv,
                   void* ctx, void* part, void* hid, int n, int u, int m, int nhead, int layers,
                   int d_ffn, int step, int dtype, int exact_gelu, int device, void* stream) {
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_typed<float>(x0, mask, kv, kv_act, table, act_src, wall, vecs, xs, qkv, ctx, part,
                               hid, n, u, m, nhead, layers, d_ffn, step, exact_gelu, device, s);
  }
  if (dtype == 1) {
    return launch_typed<bf16>(x0, mask, kv, kv_act, table, act_src, wall, vecs, xs, qkv, ctx, part,
                              hid, n, u, m, nhead, layers, d_ffn, step, exact_gelu, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef SA_LM_MEGA_STAMPS
// The stamped build only: copies the last launch's kStamps timer reads (ns)
// to `host`; returns the cudaError_t.
int sa_lm_megastep_stamps(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, stamps, sizeof(stamps)));
}
#endif

}  // extern "C"

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
// kept). f32, bf16 and int8 caches. int8 (the JAX package's quantized
// serving mode, ops/attention_step.py's contract): codes, with (L, N, U) f32
// k and v scales by own row and logical position; each row's head-0
// attention item quantizes the row's fresh k/v (the bf16-valued f32 q/k/v
// scratch, complete for every head after the q/k/v phase's grid barrier)
// into the merged page and writes the scales at (layer, row, step) in place;
// the attention is K4/K6's int8 body (attn_step_chunked_i8: the scales
// factored out of tensor-core products on the raw codes, d_head 32, 64, 96
// or 128, its shared memory inside this kernel's 50.2 KB). The weights and
// the projections are as for f32 caches.
//
// Bound: at the D2 decode shape (N 528, U 256, M 768, 12 layers, d_ffn 3072)
// a step must read 12 layers' live cache (the positions its rows hold valid,
// each distinct page once, ~320 MB a layer in f32 mid-decode), write each
// row's merged active page, and read 170 MB of bf16 weights: ~4 GB, ~1.2 ms
// at 3.35 TB/s. Its 89.7 GFLOP of products take 0.09 ms at the bf16 tensor
// cores' peak. So it is bound by device-memory bytes, mostly the cache's.
// An int8 cache holds a quarter of f32's bytes, plus 8 bytes of scales a
// row and position.
//
// Design: the TPU kernel is one grid step on one core walking all N rows in
// VMEM; its point is one dispatch for a whole LM step, the layers' matmuls
// overlapping the weight streams. Here that becomes one persistent
// cooperative launch: a grid of as many 128-thread blocks as the card holds
// at once (cudaLaunchCooperativeKernel guarantees they are co-resident), a
// prologue (x0 to bf16), and each layer as seven phases separated by
// grid-wide barriers (cooperative_groups::this_grid().sync()), each phase a
// loop of its work items over the blocks:
//   1. q/k/v: 64 x 64 output tiles of the three projections;
//   2. attention: one item per (row, head), K6's device body, its output
//      written as bf16 (the out-projection's operand);
//   3. out-projection in two K-slices, each tile's f32 sum to scratch;
//   4. sum of the slices + bias + residual, LayerNorm 1 (a warp a row), x in
//      f32 and bf16;
//   5. W1 + bias + gelu into an (N, d_ffn) bf16 hidden buffer (3.2 MB at D2,
//      it stays in L2);
//   6. W2 in nf K-slices (its row blocks), each tile's f32 sum to scratch;
//   7. sum of the slices + bias + residual, LayerNorm 2, x in f32 and bf16.
// The K-slices give the grid 2x and nf x the out-projection's and W2's few
// 64 x 64 tiles (108 at D2 for ~530 blocks); their sums are added in a fixed
// order, so a launch is deterministic.
//
// What bounds it on this card, and what the design does about it:
//   - the products are latency- and L2-bound, not tensor-core-bound: each
//     phase has fewer 64 x 64 tiles than the grid has blocks (q/k/v 324,
//     out-projection 216, W1 and W2 432 at D2), so a phase lasts about one
//     tile, and each tile re-reads its operands from L2. A tile is one
//     warpgroup's wgmma m64n64k16 (bf16, f32 accumulators in registers, A
//     and B from shared memory; B N-major, the weights as they lie) over a
//     ring of kStages shared-memory stages, each a 64 x 64 box of A and of B
//     that one thread's TMA loads (128-byte swizzle, completion on an
//     mbarrier) bring kStages stages ahead (gemm_tile); the operands are
//     bf16 in global memory (x, the attention output and the hidden are
//     stored as bf16 by the phases that make them), so no thread stages
//     them through registers or issues their addresses; a phase that
//     stores what the next one loads with TMA ends with a cross-proxy fence
//     (fence.proxy.async) before its barrier;
//   - the attention phase is bound by the latency of its dependent cache
//     loads (csrc/attention_step.cuh: lanes on (position, vector), several
//     positions' loads in flight); it wants many blocks an SM, the products
//     registers and ring memory (kMinBlocks, kDepth, kStages);
//   - the 85 grid barriers a step (7 a layer and the prologue's): no phase
//     can take its own prologue without re-reading whole rows per tile (a
//     q/k/v or W1 tile computing LayerNorm of its 64 rows would read 24x to
//     48x the rows' f32 sums from L2), so each stays; the stamped build
//     measures one barrier (tools/profile_lm_megastep.py).
// Intermediate activations live in global scratch that the wrapper allocates
// (x, q/k/v, attention output, K-slice sums, hidden; ~17 MB at D2, in L2).
// Limits checked by the Python wrapper: M a multiple of 128, d_ffn a multiple
// of M, K6's head-width and alignment limits, page 64.

#include <cooperative_groups.h>
#include "attention_step.cuh"

#ifdef SA_LM_MEGA_STAMPS
// The build of tools/profile_lm_megastep.py: block 0 reads the card's global
// timer at the start, after two back-to-back grid barriers (one barrier's
// cost), and after every grid barrier of the step (the prologue's, then 7 a
// layer).
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

constexpr int kTile = 64;   // output rows and columns of a product tile
constexpr int kDepth = 64;  // K per ring stage: one 128-byte swizzle row of bf16
constexpr int kStages = 3;  // shared-memory stages of a block's ring
constexpr uint32_t kBox = kTile * kDepth * sizeof(__nv_bfloat16);  // one operand's stage, 8 KB
constexpr uint32_t kStageBytes = 2 * kBox;
// 1024-byte alignment slack (the swizzled stages need it), the ring, its mbarriers
constexpr size_t kGemmSmem = 1024 + kStages * kStageBytes + 8 * kStages;
constexpr int kPageShift = 6;  // page 64
constexpr float kLnEps = 1e-6f;
static_assert(kStages >= 2, "ring depth");

// The operands of one launch.
template <typename T>
struct Mega {
  // TMA maps of the products' bf16 operands, 64 x 64 boxes, 128-byte swizzle
  CUtensorMap tm_x;    // xb (n, m)
  CUtensorMap tm_ctx;  // ctx (n, m)
  CUtensorMap tm_hid;  // hid (n, d_ffn)
  CUtensorMap tm_w;    // wall as (layers * nb * m, m)
  const float* x0;            // (n, m)
  const unsigned char* mask;  // (n, u), nonzero = valid key
  T* kv;                      // (layers, n, 2u, m)
  T* kv_act;                  // (layers, n, 2, 128, m)
  const int* table;           // (n, u / 64)
  const int* act_src;         // (n,)
  const float* vecs;          // (layers, nv, m)
  float* ks;                  // int8: (layers, n, u) k and v scales; null otherwise
  float* vs;
  float* xs;                  // (n, m): x after each layer; the output
  bf16* xb;                   // (n, m): bf16(x), the projections' operand
  float* qkv;                 // (3, n, m): bf16-valued q, k, v
  bf16* ctx;                  // (n, m): bf16(attention output)
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

// TMA: the box at (x, y) (x the inner coordinate) of `map` to shared address
// `dst`, completing on `bar`.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// A wgmma shared-memory matrix descriptor, 128-byte swizzle: rows of 128
// bytes (64 bf16) in atoms of 8 rows, `sbo` bytes between atoms; `lbo` bytes
// between 64-element groups along the 128-byte rows (none here: a box is one
// group wide).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 f32, the warpgroup's accumulator fragment) += A (64 x 16, K-major)
// x B (16 x 64, N-major: flax's (in, out) weights as they lie), both bf16 in
// shared memory.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// A block's ring of kStages shared-memory stages (A's box, then B's), each
// with an mbarrier that its TMA loads complete. `pos` counts the stages the
// block has used, so stage s of the block's life sits in slot s % kStages
// and waits for mbarrier phase (s / kStages) & 1.
struct Ring {
  uint32_t base;  // slot 0, 1024-byte aligned
  uint32_t bars;  // kStages mbarriers
  unsigned pos;
};

// One 64 x 64 output tile of a product: rows r0 .. r0 + 63 (those below n)
// of the bf16 A (columns ax ..) of map ta, times the bf16 (K, 64) panel of
// map tb at column bx, rows by .. by + K - 1. epi(row, col, acc) receives
// every f32 sum of the tile, col within the tile. All kThreads threads (one
// warpgroup) call it.
//
// Thread 0 keeps up to kStages stages' TMA loads in flight (a stage: A's 64 x
// 64 box and B's, 128-byte swizzled; rows of A past n come as zeros); every
// thread waits on the stage's mbarrier, the warpgroup runs kDepth / 16 wgmma
// m64n64k16 on it (A K-major, B N-major, both from shared memory), and after
// one barrier (every warp's products of the slot done) thread 0 refills the
// slot with the stage kStages ahead.
template <typename Epi>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* ta, int ax, int r0, int n, int K,
                                          const CUtensorMap* tb, int bx, int by, Ring& ring,
                                          Epi epi) {
  const int nk = K / kDepth;
  const auto issue = [&](int kt) {
    const unsigned slot = (ring.pos + kt) % kStages;
    const uint32_t dst = ring.base + slot * kStageBytes, bar = ring.bars + 8 * slot;
    mbar_expect(bar, kStageBytes);
    tma_2d(dst, ta, bar, ax + kt * kDepth, r0);
    tma_2d(dst + kBox, tb, bar, bx, by + kt * kDepth);
  };
  if (threadIdx.x == 0) {
    for (int kt = 0; kt < nk && kt < kStages; ++kt) issue(kt);
  }
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const unsigned st = ring.pos + kt;
    const uint32_t a = ring.base + (st % kStages) * kStageBytes;
    while (!mbar_done(ring.bars + 8 * (st % kStages), (st / kStages) & 1)) {
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k16 = 0; k16 < kDepth / 16; ++k16) {
      // A: 32 bytes along its swizzled rows a step; B: 16 of its rows (2048 bytes)
      wgmma_64x64x16(d, gmma_desc(a + 32 * k16, 16, 1024), gmma_desc(a + kBox + 2048 * k16, 1024, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();  // every warp is done with the slot
    if (threadIdx.x == 0 && kt + kStages < nk) issue(kt + kStages);
  }
  ring.pos += nk;
  // the accumulator fragment: warp w holds rows 16 w .. 16 w + 15; per 8
  // columns, lane l holds (l / 4, 2 (l % 4) + {0, 1}) and 8 rows below
  const int t = threadIdx.x;
  const int row = 16 * (t >> 5) + ((t & 31) >> 2), col = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r0 + r < n) {
        epi(r0 + r, 8 * j + col, d[4 * j + 2 * h]);
        epi(r0 + r, 8 * j + col + 1, d[4 * j + 2 * h + 1]);
      }
    }
  }
}

// For every row, one warp a row: x = resid + (part[0] + ... + part[parts -
// 1] + pbias), the product's K-slices summed in order; out = LN(x) and outb
// = bf16(out). out may be resid: each lane reads and writes only its own
// elements. 16-byte accesses: m a multiple of 4.
__device__ __forceinline__ void add_norm_rows(const float* part, int parts, const float* pbias,
                                              const float* resid, const float* scale,
                                              const float* bias, float* out, bf16* outb, int n,
                                              int m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t nm = static_cast<size_t>(n) * m;
  for (int r = blockIdx.x * kWarps + warp; r < n; r += gridDim.x * kWarps) {
    const size_t row = static_cast<size_t>(r) * m;
    float s = 0.f, s2 = 0.f;
    for (int c = 4 * lane; c < m; c += 128) {
      float4 v = *reinterpret_cast<const float4*>(part + row + c);
      for (int k = 1; k < parts; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(part + k * nm + row + c);
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      const float4 b = *reinterpret_cast<const float4*>(pbias + c);
      const float4 x = *reinterpret_cast<const float4*>(resid + row + c);
      v = make_float4(x.x + (v.x + b.x), x.y + (v.y + b.y), x.z + (v.z + b.z), x.w + (v.w + b.w));
      *reinterpret_cast<float4*>(out + row + c) = v;
      s += (v.x + v.y) + (v.z + v.w);
      s2 = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, s2))));
    }
    const float mu = warp_sum(s) / m;
    const float var = fmaxf(warp_sum(s2) / m - mu * mu, 0.f);
    const float rs = rsqrtf(var + kLnEps);
    for (int c = 4 * lane; c < m; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(out + row + c);
      const float4 g = *reinterpret_cast<const float4*>(scale + c);
      const float4 b = *reinterpret_cast<const float4*>(bias + c);
      const float4 y = make_float4((v.x - mu) * rs * g.x + b.x, (v.y - mu) * rs * g.y + b.y,
                                   (v.z - mu) * rs * g.z + b.z, (v.w - mu) * rs * g.w + b.w);
      *reinterpret_cast<float4*>(out + row + c) = y;
      __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(outb + row + c);
      ob[0] = __floats2bfloat162_rn(y.x, y.y);
      ob[1] = __floats2bfloat162_rn(y.z, y.w);
    }
  }
}

// The out-projection's K-slices (K = M): more work items for the grid.
constexpr int kOutSlices = 2;

// At least kMinBlocks blocks an SM: the attention phase wants warps in
// flight, the products registers (32 accumulators a thread) and the ring's
// shared memory. PERF.md has the variants measured.
constexpr int kMinBlocks = 4;

template <typename T, bool kExact>
__global__ void __launch_bounds__(kThreads, kMinBlocks) lm_mega(const __grid_constant__ Mega<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  Ring ring;
  ring.base = (smem_addr(smem) + 1023) & ~1023u;
  ring.bars = ring.base + kStages * kStageBytes;
  ring.pos = 0;
  if (threadIdx.x == 0) {
    for (int sl = 0; sl < kStages; ++sl) mbar_init(ring.bars + 8 * sl);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int passed = 0;  // grid barriers passed, for the stamped build's timer reads
  const auto barrier = [&] {
    grid.sync();
    stamp(++passed);
  };
  // A barrier before a phase whose TMA loads (the async proxy) read what this
  // phase wrote with ordinary stores (the generic proxy): xb, ctx or hid in
  // global memory, and after the attention the shared memory that the ring's
  // TMA then overwrites. The cross-proxy fence orders the two.
  const auto barrier_to_tma = [&] {
    asm volatile("fence.proxy.async;\n" ::: "memory");
    barrier();
  };
  stamp(0);
#ifdef SA_LM_MEGA_STAMPS
  barrier();  // two barriers with nothing between: one barrier's cost
  barrier();
#endif
  const int n = p.n, m = p.m;
  const size_t nm = static_cast<size_t>(n) * m;
  const int nf = p.d_ffn / m, nb = 4 + 2 * nf, nv = 9 + nf;
  const int tiles_r = (n + kTile - 1) / kTile, tiles_m = m / kTile;
  const int d_head = m / p.nhead;

  Args<T> a = {};
  a.q = p.qkv;
  a.kh = p.qkv + nm;
  a.vh = p.qkv + 2 * nm;
  a.mask = p.mask;
  a.ks = p.ks;
  a.vs = p.vs;
  a.ck = a.cv = p.kv;
  a.ak = a.av = p.kv_act;
  a.table = p.table;
  a.act_src = p.act_src;
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

  // 0. xb = bf16(x0)
  for (size_t i = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * 4; i < nm;
       i += static_cast<size_t>(gridDim.x) * kThreads * 4) {
    const float4 v = *reinterpret_cast<const float4*>(p.x0 + i);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(p.xb + i);
    o[0] = __floats2bfloat162_rn(v.x, v.y);
    o[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  barrier_to_tma();

  for (int l = 0; l < p.layers; ++l) {
    const float* xin = l == 0 ? p.x0 : p.xs;
    const float* vec = p.vecs + static_cast<size_t>(l) * nv * m;

    // 1. q, k, v = bf16(bf16(x) @ W + b)
    for (int t = blockIdx.x; t < 3 * tiles_r * tiles_m; t += gridDim.x) {
      const int j = t / (tiles_r * tiles_m), rest = t % (tiles_r * tiles_m);
      const int r0 = rest / tiles_m * kTile, c0 = rest % tiles_m * kTile;
      const float* b = vec + j * m + c0;
      float* out = p.qkv + j * nm + c0;
      gemm_tile(&p.tm_x, 0, r0, n, m, &p.tm_w, c0, (l * nb + j) * m, ring,
                [&](int r, int c, float s) { out[static_cast<size_t>(r) * m + c] = to_bf16(s + b[c]); });
    }
    barrier();

    // 2. attention over the paged cache; writes ctx (bf16) and the merged pages
    a.layer = l;
    for (int item = blockIdx.x; item < n * p.nhead; item += gridDim.x) {
      attn_step_chunked_item<T, true>(a, item, reinterpret_cast<float*>(smem), p.ctx);
      __syncthreads();
    }
    barrier_to_tma();

    // 3. part[s] = bf16(ctx)[:, slice s] @ Wo[slice s, :], kOutSlices K-slices
    const int ks = m / kOutSlices;
    for (int t = blockIdx.x; t < kOutSlices * tiles_r * tiles_m; t += gridDim.x) {
      const int s = t / (tiles_r * tiles_m), rest = t % (tiles_r * tiles_m);
      const int r0 = rest / tiles_m * kTile, c0 = rest % tiles_m * kTile;
      float* out = p.part + s * nm + c0;
      gemm_tile(&p.tm_ctx, s * ks, r0, n, ks, &p.tm_w, c0, (l * nb + 3) * m + s * ks, ring,
                [&](int r, int c, float acc) { out[static_cast<size_t>(r) * m + c] = acc; });
    }
    barrier();

    // 4. x = LN1(x + (part[0] + part[1] + bo))
    add_norm_rows(p.part, kOutSlices, vec + 3 * m, xin, vec + (5 + nf) * m, vec + (6 + nf) * m, p.xs,
                  p.xb, n, m);
    barrier_to_tma();

    // 5. hid = bf16(gelu(bf16(x) @ W1 + b1)), W1's column block c in wall block 4 + 2c
    const int tiles_f = p.d_ffn / kTile;
    for (int t = blockIdx.x; t < tiles_r * tiles_f; t += gridDim.x) {
      const int r0 = t / tiles_f * kTile, c0 = t % tiles_f * kTile;
      const float* b = vec + 4 * m + c0;  // the nf b1 rows are b1, contiguous
      gemm_tile(&p.tm_x, 0, r0, n, m, &p.tm_w, c0 % m, (l * nb + 4 + 2 * (c0 / m)) * m, ring,
                [&](int r, int c, float s) {
                  p.hid[static_cast<size_t>(r) * p.d_ffn + c0 + c] =
                      __float2bfloat16_rn(gelu<kExact>(s + b[c]));
                });
    }
    barrier_to_tma();

    // 6. part[c] = hid[:, block c] @ W2[block c, :], W2's row block c in wall
    // block 5 + 2c: nf K-slices
    for (int t = blockIdx.x; t < nf * tiles_r * tiles_m; t += gridDim.x) {
      const int c = t / (tiles_r * tiles_m), rest = t % (tiles_r * tiles_m);
      const int r0 = rest / tiles_m * kTile, c0 = rest % tiles_m * kTile;
      float* out = p.part + c * nm + c0;
      gemm_tile(&p.tm_hid, c * m, r0, n, m, &p.tm_w, c0, (l * nb + 5 + 2 * c) * m, ring,
                [&](int r, int col, float acc) { out[static_cast<size_t>(r) * m + col] = acc; });
    }
    barrier();

    // 7. x = LN2(x + (part[0] + ... + part[nf - 1] + b2))
    add_norm_rows(p.part, nf, vec + (4 + nf) * m, p.xs, vec + (7 + nf) * m, vec + (8 + nf) * m, p.xs,
                  p.xb, n, m);
    barrier_to_tma();
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
  size_t attn;  // the attention phase's shared memory, from the block's start
  if constexpr (Vec<T>::kQuant) {
    // int8: d_head 32, 64, 96 or 128, and below the ring's mbarriers
    attn = static_cast<size_t>(
        chunked_i8_smem(d_head, i8_stages(d_head / 16), p.u, p.u >> kPageShift));
    if (d_head % 32 != 0 || d_head > 128 || attn > kStages * kStageBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    const int groups = kThreads / (d_head / Vec<T>::kN);
    attn = static_cast<size_t>(chunked_smem_floats(groups, d_head)) * sizeof(float) +
           static_cast<size_t>(p.u >> kPageShift) * sizeof(int);
  }
  const size_t smem = attn > kGemmSmem ? attn : kGemmSmem;
  static int smem_set[kMaxDevices] = {};
  const int opt_in = allow_smem(kernel, smem, device, smem_set);  // above 48 KB
  if (opt_in != 0) return opt_in;
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

// The TMA map of a (rows, cols) row-major bf16 matrix in kTile x kDepth
// boxes (kDepth columns: 128 bytes, swizzled), rows past `rows` read as
// zeros. Returns 0 or a CUDA error.
int encode_2d(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {kDepth, kTile};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_typed(const void* x0, const void* mask, void* kv, void* kv_act, const void* table,
                 const void* act_src, const void* wall, const void* vecs, void* ks, void* vs,
                 void* xs, void* xb, void* qkv, void* ctx, void* part, void* hid, int n, int u,
                 int m, int nhead, int layers, int d_ffn, int step, int exact_gelu, int device,
                 cudaStream_t stream) {
  Mega<T> p = {};
  p.x0 = static_cast<const float*>(x0);
  p.mask = static_cast<const unsigned char*>(mask);
  p.kv = static_cast<T*>(kv);
  p.kv_act = static_cast<T*>(kv_act);
  p.table = static_cast<const int*>(table);
  p.act_src = static_cast<const int*>(act_src);
  p.vecs = static_cast<const float*>(vecs);
  p.ks = static_cast<float*>(ks);
  p.vs = static_cast<float*>(vs);
  p.xs = static_cast<float*>(xs);
  p.xb = static_cast<bf16*>(xb);
  p.qkv = static_cast<float*>(qkv);
  p.ctx = static_cast<bf16*>(ctx);
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
  const int nb = 4 + 2 * (d_ffn / m);
  int err = encode_2d(&p.tm_x, xb, n, m);
  if (err == 0) err = encode_2d(&p.tm_ctx, ctx, n, m);
  if (err == 0) err = encode_2d(&p.tm_hid, hid, n, d_ffn);
  if (err == 0) err = encode_2d(&p.tm_w, wall, static_cast<uint64_t>(layers) * nb * m, m);
  if (err != 0) return err;
  return exact_gelu ? launch<T, true>(p, device, stream) : launch<T, false>(p, device, stream);
}

}  // namespace

extern "C" {

// One TransformerLM decode step. x0: (n, m) f32; mask: (n, u) bytes,
// nonzero = valid key; kv: (layers, n, 2u, m) and kv_act (layers, n, 2, 128,
// m), f32 (dtype 0), bf16 (dtype 1) or int8 codes (dtype 2) with ks, vs
// their (layers, n, u) f32 scales (null otherwise; the launch writes each
// layer's fresh scales at (layer, :, step)); table: (n, u / 64) int32;
// act_src: (n,) int32; wall: (layers * (4 + 2 d_ffn / m), m, m) bf16; vecs:
// (layers, 9 + d_ffn / m, m) f32. Scratch the caller allocates: xs (n, m)
// f32, xb and ctx (n, m) bf16, qkv (3, n, m) f32, part (max(d_ffn / m, 2), n,
// m) f32, hid (n, d_ffn) bf16. Writes x_out into xs and every layer's merged active page
// (slot step % 2, or main page step / 64 when it completes). All contiguous
// on `device`, 16-byte aligned. One cooperative launch on `stream`; returns
// its cudaError_t (0 on success). Does not synchronise.
int sa_lm_megastep(const void* x0, const void* mask, void* kv, void* kv_act, const void* table,
                   const void* act_src, const void* wall, const void* vecs, void* ks, void* vs,
                   void* xs, void* xb, void* qkv, void* ctx, void* part, void* hid, int n, int u,
                   int m, int nhead, int layers, int d_ffn, int step, int dtype, int exact_gelu,
                   int device, void* stream) {
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_typed<float>(x0, mask, kv, kv_act, table, act_src, wall, vecs, ks, vs, xs, xb,
                               qkv, ctx, part, hid, n, u, m, nhead, layers, d_ffn, step,
                               exact_gelu, device, s);
  }
  if (dtype == 1) {
    return launch_typed<bf16>(x0, mask, kv, kv_act, table, act_src, wall, vecs, ks, vs, xs, xb,
                              qkv, ctx, part, hid, n, u, m, nhead, layers, d_ffn, step,
                              exact_gelu, device, s);
  }
  if (dtype == 2) {
    return launch_typed<int8_t>(x0, mask, kv, kv_act, table, act_src, wall, vecs, ks, vs, xs, xb,
                                qkv, ctx, part, hid, n, u, m, nhead, layers, d_ffn, step,
                                exact_gelu, device, s);
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

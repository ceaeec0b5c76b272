// The device code that the single-token attention kernels share: K3-K6 of
// csrc/attention_step.cu and the attention phase of K7 (csrc/lm_megastep.cu).
// Numerics, addressing and design are stated in csrc/attention_step.cu's
// header. Each (row, head) pair is one work item of 128 threads; K4-K6 run
// one item per block, K3 and K7 walk many items per block.

#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // positions per chunk of the streamed kernel
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory without opting in
constexpr int kMaxDevices = 64;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;  // elements in 16 bytes
  static constexpr bool kQuant = false;  // int8 codes with a scale per position
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static constexpr bool kQuant = false;
};
template <>
struct Vec<int8_t> {
  static constexpr int kN = 16;
  static constexpr bool kQuant = true;
};

// x rounded to the cache's element type (to nearest even), as a float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 int8 codes -> floats, each dequantized as code * scale in f32 (the
// int8 contract: no product before the dequantization), by K3 and K5: each
// code made a float exactly as (2^23 + code + 128) - (2^23 + 128), its bits
// assembled by a byte permute, where an integer-to-float conversion runs at
// an eighth of the FMA rate (3-8% faster K3 on an H100). K4, K6 and K7 take
// the codes to the tensor cores as f16 (attn_step_chunked_i8).
__device__ __forceinline__ void unpack_codes(const uint4& r, float (&x)[16], float scale) {
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                         r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = (__uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7540u | (i % 4))) - 8388736.f) *
           scale;
  }
}

// floats -> 16 int8 codes: clip(round-half-even(x * inv), -127, 127), inv = 127 / amax
__device__ __forceinline__ void store_codes(int8_t* p, const float (&x)[16], float inv) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float c = fminf(fmaxf(rintf(x[i] * inv), -127.f), 127.f);
    w[i / 4] |= (static_cast<uint32_t>(static_cast<int>(c)) & 0xffu) << (8 * (i % 4));
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 bytes of cache elements, as loaded -> floats
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// floats -> 16 bytes of cache elements (values already rounded: exact)
__device__ __forceinline__ void store_vec(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&x)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// kN consecutive f32 values of a fresh (N, M) operand, rounded to T
template <typename T, int N>
__device__ __forceinline__ void load_fresh(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * i);
    x[4 * i] = round_to<T>(v.x);
    x[4 * i + 1] = round_to<T>(v.y);
    x[4 * i + 2] = round_to<T>(v.z);
    x[4 * i + 3] = round_to<T>(v.w);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Every thread gets the block's sum (max); `red` holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The mbarrier at shared address `bar`: init (one arrival a phase), the
// arrival that also expects `bytes` of asynchronous-copy data, whether the
// phase of parity `parity` has completed, and the wait for it.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_done(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_done(bar, parity)) {
  }
}

// A bulk asynchronous copy (no tensor map) of `bytes` (a multiple of 16,
// both addresses 16-byte aligned) from global `src` to shared address `dst`,
// completing on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA: the box at (x, y, z) (x the inner coordinate) of the 3-D `map` to
// shared address `dst` (128-byte aligned), completing on the mbarrier at
// `bar`; elements outside the tensor (negative y) arrive as zeros.
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                       int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda); null if the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      encode = reinterpret_cast<EncodeTiled>(fn);
    }
  }
  return encode;
}

// Raises `kernel`'s dynamic shared-memory limit to `smem` where that is above
// the default 48 KB, once per device and size (`set` records what each device
// was given). Returns 0 or the CUDA error.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, int device, int (&set)[kMaxDevices]) {
  if (smem <= kDefaultSmem) return 0;
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (static_cast<int>(smem) > set[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    set[device] = static_cast<int>(smem);
  }
  return 0;
}

// The operands of one launch. Sizes in positions (rows of M elements).
template <typename T>
struct Args {
  const float* q;
  const float* kh;
  const float* vh;
  const unsigned char* mask;
  T* ck;  // main k cache; fused layout: the kv cache
  T* cv;  // main v cache; fused layout: the same kv cache
  T* ak;  // paged: active-page parity slots of k; fused: the kv slots
  T* av;
  const int* table;    // paged: (n, u / page) owner row of each completed page
  const int* act_src;  // paged: (n,) beam parent holding the active page
  float* out;
  int n, u, m, d_head, step, layer;
  int page_shift;  // paged: log2(page)
  int row_pos;     // between rows of the main cache: u (physical, split), 2u (fused)
  int page_pos;    // between pages of a row: page (split), 2 page (fused)
  int slot_pos;    // in one parity slot: page (split), 2 page (fused)
  int v_off;       // from a k page or slot to its v: 0 (split), page (fused)
  float scale;
  float* ks;  // int8: (L, n, u) scales of k and v by own row and logical
  float* vs;  //   position; position `step` written by the launch
};

// What both kernels share for one (row, head) work item, `item` = row * H +
// head (a block's index in K4-K6): the fresh operands,
// the address of any position of the row, and (in the constructor) the
// in-place writes. `item` is unsigned, as blockIdx.x is: with a signed index
// the division and remainder by H cost K6 ~20 more registers, a third fewer
// resident blocks and ~18% of its time on an H100.
template <typename T, bool kPaged>
struct Head {
  static constexpr int V = Vec<T>::kN;
  const T* kmain;  // physical: this row's position 0; paged: the layer's row 0
  const T* vmain;  //   (all with this head's offset)
  const T* kact;   // paged: the parent's read slot at the first active position
  const T* vact;
  T* kmerge;       // paged: where the merged active page goes (its first position)
  T* vmerge;
  const int* owners;  // paged: shared memory, the owner row of each completed page
  const unsigned char* mrow;  // mask row
  float* ksrow;  // int8: this layer's and row's scales by position
  float* vsrow;
  size_t qoff;        // offset of this head in the (N, M) operands
  size_t row_stride;  // paged: elements between rows of the main cache
  int m, nvec, lane, warp;
  int act_start, page_shift, page_pos;  // paged
  bool live;          // lane < nvec: holds a vector of the head

  // copy: the paged constructor copies the parent's active positions to the
  // merged page itself (K5); K6's body copies them as its passes read them.
  // f32 and bf16: the constructor writes this head's fresh k/v; on int8
  // caches it writes nothing at `step`: the chunked body quantizes the row
  // once, in its head-0 block.
  __device__ Head(const Args<T>& a, const int* owners_, unsigned item, bool copy = true)
      : owners(owners_), m(a.m) {
    const int nhead = m / a.d_head;
    const int row = item / nhead;
    const size_t hoff = static_cast<size_t>(item % nhead) * a.d_head;
    nvec = a.d_head / V;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    live = lane < nvec;
    qoff = static_cast<size_t>(row) * m + hoff;
    mrow = a.mask + static_cast<size_t>(row) * a.u;
    float kv[V];  // this lane's vector of the fresh k
    if (!Vec<T>::kQuant && live) load_fresh<T>(a.kh + qoff + lane * V, kv);
    T* kdst;  // where the fresh k/v land
    T* vdst;
    const size_t layer_row0 = static_cast<size_t>(a.layer) * a.n;
    if constexpr (!kPaged) {
      const size_t base = (layer_row0 + row) * a.u * m + hoff;
      kmain = a.ck + base;
      vmain = a.cv + base;
      // no block of this launch reads the cache at `step`
      kdst = a.ck + base + static_cast<size_t>(a.step) * m;
      vdst = a.cv + base + static_cast<size_t>(a.step) * m;
    } else {
      const int page = 1 << a.page_shift;
      page_shift = a.page_shift;
      page_pos = a.page_pos;
      act_start = a.step & ~(page - 1);
      const int o = a.step - act_start;
      row_stride = static_cast<size_t>(a.row_pos) * m;
      kmain = a.ck + layer_row0 * row_stride + hoff;
      vmain = a.cv + layer_row0 * row_stride + static_cast<size_t>(a.v_off) * m + hoff;
      const int parent = a.act_src[row];
      const size_t slot_r = ((layer_row0 + parent) * 2 + ((a.step + 1) & 1)) * a.slot_pos;
      kact = a.ak + slot_r * m + hoff;
      vact = a.av + (slot_r + a.v_off) * m + hoff;
      // the merged active page goes to this row: the main cache when the
      // page completes, else parity slot step % 2
      T* kd;
      T* vd;
      if (o == page - 1) {
        const size_t at =
            (layer_row0 + row) * a.row_pos + static_cast<size_t>(a.step >> a.page_shift) * a.page_pos;
        kd = a.ck + at * m + hoff;
        vd = a.cv + (at + a.v_off) * m + hoff;
      } else {
        const size_t at = ((layer_row0 + row) * 2 + (a.step & 1)) * a.slot_pos;
        kd = a.ak + at * m + hoff;
        vd = a.av + (at + a.v_off) * m + hoff;
      }
      kmerge = kd;
      vmerge = vd;
      // the parent's positions act_start .. step - 1, k then v, as bytes
      const int span = copy ? o * nvec : 0;
      for (int i = threadIdx.x; i < 2 * span; i += kThreads) {
        const bool is_v = i >= span;
        const int r = is_v ? i - span : i;
        const size_t off = static_cast<size_t>(r / nvec) * m + (r % nvec) * V;
        *reinterpret_cast<uint4*>((is_v ? vd : kd) + off) =
            *reinterpret_cast<const uint4*>((is_v ? vact : kact) + off);
      }
      kdst = kd + static_cast<size_t>(o) * m;
      vdst = vd + static_cast<size_t>(o) * m;
    }
    if constexpr (Vec<T>::kQuant) {
      ksrow = a.ks + (layer_row0 + row) * a.u;
      vsrow = a.vs + (layer_row0 + row) * a.u;
    }
    if constexpr (!Vec<T>::kQuant) {
      if (warp == 0 && live) store_vec(kdst + lane * V, kv);
      if (warp == 1 && live) {
        float vv[V];
        load_fresh<T>(a.vh + qoff + lane * V, vv);
        store_vec(vdst + lane * V, vv);
      }
    }
  }

  // Address of position p < step of this row and head (k, or v with is_v).
  __device__ __forceinline__ const T* at(int p, bool is_v) const {
    if constexpr (kPaged) {
      if (p >= act_start) return (is_v ? vact : kact) + static_cast<size_t>(p - act_start) * m;
      const int pg = p >> page_shift;
      const size_t pos = static_cast<size_t>(pg) * page_pos + (p - (pg << page_shift));
      return (is_v ? vmain : kmain) + owners[pg] * row_stride + pos * m;
    } else {
      return (is_v ? vmain : kmain) + static_cast<size_t>(p) * m;
    }
  }
};

// Paged: the completed-page owners of work item `item`'s row into shared memory.
template <typename T, bool kPaged>
__device__ __forceinline__ void load_owners(const Args<T>& a, int* owners, unsigned item) {
  if constexpr (kPaged) {
    const int row = item / (a.m / a.d_head);
    const int up = a.u >> a.page_shift;
    const int done = a.step >> a.page_shift;
    for (int i = threadIdx.x; i < done; i += kThreads) {
      owners[i] = a.table[static_cast<size_t>(row) * up + i];
    }
    __syncthreads();
  }
}

// x -> an output element: f32 as is, bf16 rounded to nearest even
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Sum the groups' partial value vectors and write out = total / denom.
template <int V, typename TO>
__device__ __forceinline__ void finish(const float (&acc)[V], float denom, float* part, int g,
                                       int groups, int j, int d_head, TO* out) {
  if (g < groups) {
#pragma unroll
    for (int i = 0; i < V; ++i) part[g * d_head + j * V + i] = acc[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < d_head; d += kThreads) {
    float tot = 0.f;
    for (int gg = 0; gg < groups; ++gg) tot += part[gg * d_head + d];
    store_out(out + d, denom > 0.f ? tot / denom : 0.f);
  }
}

// Lanes per position in the score passes: d_head / vec rounded up to 8, 16
// or 32, so a warp scores 4, 2 or 1 positions at once.
__device__ __forceinline__ int score_group(int nvec) { return nvec <= 8 ? 8 : (nvec <= 16 ? 16 : 32); }

// Floats of shared memory attn_step_chunked_item takes (then u / page ints
// of page owners, paged).
__host__ __device__ constexpr int chunked_smem_floats(int groups, int d_head) {
  return 2 * kChunk + 2 * kWarps + 1 + groups * d_head;
}

// The int8 quantizer of one row's fresh k and v, quantize_rows': amax =
// max(max |x|, 1e-6) over the row's m values (every head), codes
// clip(rint(x * (127 / amax)), -127, 127) to kdst / vdst (the row's position
// of every head), scales amax / 127 to *ks / *vs, both divisions IEEE.
// Called by all kThreads threads of a block; `red` holds kWarps floats.
__device__ __forceinline__ void quantize_fresh_row(const float* krow, const float* vrow,
                                                   int8_t* kdst, int8_t* vdst, float* ks, float* vs,
                                                   int m, float* red) {
  float mk = 0.f, mv = 0.f;
  for (int i = 4 * threadIdx.x; i < m; i += 4 * kThreads) {
    const float4 k4 = *reinterpret_cast<const float4*>(krow + i);
    const float4 v4 = *reinterpret_cast<const float4*>(vrow + i);
    mk = fmaxf(mk, fmaxf(fmaxf(fabsf(k4.x), fabsf(k4.y)), fmaxf(fabsf(k4.z), fabsf(k4.w))));
    mv = fmaxf(mv, fmaxf(fmaxf(fabsf(v4.x), fabsf(v4.y)), fmaxf(fabsf(v4.z), fabsf(v4.w))));
  }
  mk = fmaxf(block_max(mk, red), 1e-6f);
  mv = fmaxf(block_max(mv, red), 1e-6f);
  const int vecs = m / Vec<int8_t>::kN;
  for (int i = threadIdx.x; i < 2 * vecs; i += kThreads) {
    const bool is_v = i >= vecs;
    const int e = (is_v ? i - vecs : i) * Vec<int8_t>::kN;  // the row's element e
    float x[Vec<int8_t>::kN];
    load_fresh<int8_t>((is_v ? vrow : krow) + e, x);
    store_codes((is_v ? vdst : kdst) + e, x, 127.f / (is_v ? mv : mk));  // IEEE division
  }
  if (threadIdx.x == 0) {
    *ks = mk / 127.f;
    *vs = mv / 127.f;
  }
}

// ---- The int8 chunked body (K4, K6 and K7 on int8 caches) ----
//
// The products run on the tensor cores (mma.sync m16n8k16, f16 operands, f32
// accumulators), on the raw codes: a code in -128..127 is an f16 exactly. The
// scales are factored out of the products, as the TPU kernel does on uniform
// pages (_subtile_update_unif, ops/pallas/attention_step.py:852-866): a
// score is k_scale[p] (q . codes_p) / sqrt(d_head), and v_scale[p] folds into
// the softmax weight before the value product. The f32 side of each product
// (q, the scaled weights) becomes three f16 terms t0 + t1 + t2 (t0 = f16(x),
// t1 = f16(x - t0), t2 = f16(x - t0 - t1)) after a power-of-two shift that
// puts its largest magnitude in [2^13, 2^14) (per item for q, per tile for the
// weights): 33 significant bits, past f32's 24. The terms are the columns
// 0-2 of the B operand (3-7 zero); each product of a code and a term is exact
// in f32; the column sums are added (t2 + t1) + t0 and shifted back.
//
// Positions go in tiles of kI8Tile; warp w takes tiles w, w + kWarps, ...
// with its own online softmax (running max, denominator, accumulators), and
// the block merges the kWarps partials and the fresh position (q . kh in
// f32, weight times vh in f32) at the end: no barrier in the position loop.
// Each warp stages its tiles (k and v codes, k and v scales) in a ring of
// slots of its own with cp.async (2 in K4 and K6, 3 in K7's attention
// phase), the next tiles' copies in flight while it computes one;
// positions that are masked (outside the parent's active page) or at or
// past the step are not read (zero-filled). The
// products read the codes with ldmatrix (rows padded by kI8Pad bytes:
// conflict-free), the values' transposed (.trans), and turn four codes into
// two f16 pairs with one xor, two byte permutes and two f16x2 subtractions.
// Paged, the warp copies the parent's active positions of its tiles from the
// ring to the merged page. K4 and K6 run the same tiles in the same order,
// so they give the same bits on the same content.
constexpr int kI8Tile = 16;  // positions a tile: the scores' mma M, the values' K
constexpr int kI8Pad = 16;   // bytes after each staged position's codes

// Ring slots a warp in K7's attention phase (its 4 blocks an SM leave
// shared memory for 3, 2 at d_head 128); K4 and K6 take 2 and more blocks.
__host__ __device__ constexpr int i8_stages(int dtiles) { return dtiles > 6 ? 2 : 3; }
__host__ __device__ constexpr int i8_pitch(int d_head) { return d_head + kI8Pad; }
// A ring slot: one tile's k codes and v codes (kI8Tile rows of i8_pitch
// bytes each), then its k and v scales (kI8Tile floats each).
__host__ __device__ constexpr int i8_slot_bytes(int d_head) {
  return 2 * kI8Tile * i8_pitch(d_head) + 2 * kI8Tile * 4;
}
// Bytes of shared memory the int8 body takes: the warps' rings of `stages`
// slots, kWarps floats of reduction scratch, the row's mask (u bytes,
// rounded up to 16), then (paged) `owners` ints of page owners.
__host__ __device__ constexpr int chunked_i8_smem(int d_head, int stages, int u, int owners) {
  return kWarps * stages * i8_slot_bytes(d_head) + 4 * kWarps + ((u + 15) & ~15) + 4 * owners;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool read) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(read ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool read) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(read ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// c += a . b, one m16n8k16 product, f16 operands, f32 accumulators
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two codes of w (four codes, each xor 0x80) picked by the byte selector
// `sel` (its nibbles 1 and 3 are 4: byte 0x64) -> an f16 pair, exactly:
// the halves are 1024 + code + 128, less 1152 (0x6480).
__device__ __forceinline__ uint32_t codes_f16x2(uint32_t w, uint32_t sel) {
  const uint32_t h = __byte_perm(w, 0x64646464u, sel);
  uint32_t out;
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(out) : "r"(h), "r"(0x64806480u));
  return out;
}
// 2^e, e in [-126, 127], exactly
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }
// The shift that puts amax (>= 0) in [2^13, 2^14): f16's range with room for
// the terms below it; 0 for 0, clamped to +-100.
__device__ __forceinline__ int f16_shift(float amax) {
  const int e = ((__float_as_int(amax) >> 23) & 0xff) - 126;  // amax in [2^(e-1), 2^e)
  return amax > 0.f ? min(max(14 - e, -100), 100) : 0;
}
// Term g of x's three-term f16 split (0 for g > 2) as f16 bits.
__device__ __forceinline__ uint32_t f16_term(float x, int g) {
  const __half t0 = __float2half_rn(x);
  const float r1 = x - __half2float(t0);  // exact
  const __half t1 = __float2half_rn(r1);
  const __half t2 = __float2half_rn(r1 - __half2float(t1));
  const __half t = g == 0 ? t0 : (g == 1 ? t1 : t2);
  return g > 2 ? 0u : static_cast<uint32_t>(__half_as_ushort(t));
}

// One (row, head) work item of an int8 cache (design above), d_head = 16 *
// kDT (kDT even), kStages ring slots a warp (>= 2). Called by all kThreads
// threads of a block; writes the head's d_head outputs to `out` (f32, or
// bf16 for K7). Shared memory `smem`: chunked_i8_smem bytes. The row's
// head-0 item quantizes the row's fresh k/v (every head) and writes its
// scales; no item reads position `step` of the cache or its scale.
template <bool kPaged, int kDT, int kStages, typename TO>
__device__ __forceinline__ void attn_step_chunked_i8(const Args<int8_t>& a, unsigned item,
                                                     unsigned char* smem, TO* out) {
  constexpr int kD = 16 * kDT;
  constexpr int kPitch = i8_pitch(kD);
  constexpr int kSlot = i8_slot_bytes(kD);
  static_assert(kDT % 2 == 0 && kDT <= 8, "d_head 32, 64, 96 or 128");
  float* red = reinterpret_cast<float*>(smem + kWarps * kStages * kSlot);
  unsigned char* msk = reinterpret_cast<unsigned char*>(red + kWarps);  // the row's mask
  int* owners = reinterpret_cast<int*>(msk + ((a.u + 15) & ~15));
  const int step = a.step;
  const int m = a.m;
  const int nhead = m / kD;
  {  // the row's mask up to the step, beside the page owners (one barrier for both)
    const unsigned char* mrow = a.mask + static_cast<size_t>(item / nhead) * a.u;
    for (int p = threadIdx.x; p <= step; p += kThreads) msk[p] = mrow[p];
    if constexpr (!kPaged) __syncthreads();
  }
  load_owners<int8_t, kPaged>(a, owners, item);
  const Head<int8_t, kPaged> hd(a, owners, item, false);
  const int act_start = kPaged ? hd.act_start : step;
  const int lane = hd.lane, warp = hd.warp;
  const int g = lane >> 2, tq = lane & 3;  // the mma fragments' group and thread in group

  // This warp's tiles: i-th = positions kI8Tile (warp + kWarps i) ..., of the
  // ntiles that hold the cached positions 0 .. step - 1.
  const int ntiles = (step + kI8Tile - 1) / kI8Tile;
  const int mine = ntiles > warp ? (ntiles - 1 - warp) / kWarps + 1 : 0;
  unsigned char* const ring = smem + warp * kStages * kSlot;
  const uint32_t ring_s = smem_addr(ring);
  // Tile i into slot i % kStages: codes of the positions below the step that
  // are valid or on the parent's active page, scales of the valid ones,
  // zeros for the rest (not read).
  const auto issue = [&](int i) {
    const int p0 = kI8Tile * (warp + kWarps * i);
    const uint32_t slot = ring_s + (i % kStages) * kSlot;
    // a tile lies within one page (kI8Tile divides the page) and on one side
    // of act_start: its positions are p0's address plus r rows
    const int8_t* kbase = p0 < step ? hd.at(p0, false) : hd.kmain;
    const int8_t* vbase = p0 < step ? hd.at(p0, true) : hd.kmain;
#pragma unroll
    for (int it = 0; it < kDT; ++it) {  // 2 kI8Tile kDT 16-byte pieces, kDT a lane
      const int x = lane + 32 * it;
      const bool is_v = x >= kI8Tile * kDT;
      const int y = is_v ? x - kI8Tile * kDT : x;
      const int r = y / kDT, j = y % kDT;
      const int p = p0 + r;
      const bool read = p < step && (msk[p] || p >= act_start);
      cp_async16(slot + (is_v ? kI8Tile * kPitch : 0) + r * kPitch + 16 * j,
                 (read ? (is_v ? vbase : kbase) + r * m : hd.kmain) + 16 * j, read);
    }
    const int p = p0 + (lane & (kI8Tile - 1));
    const bool read = p < step && msk[p];
    cp_async4(slot + 2 * kI8Tile * kPitch + 4 * lane,
              read ? (lane < kI8Tile ? hd.ksrow : hd.vsrow) + p : hd.ksrow, read);
  };
  // the first tiles' copies fly while the quantizer and q's terms are made
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();
  }

  if (item % nhead == 0) {  // the row's head-0 item: the quantizer, once a row
    const size_t row = item / nhead;
    int8_t* kd;
    int8_t* vd;
    if constexpr (kPaged) {
      kd = hd.kmerge + static_cast<size_t>(step - act_start) * m;
      vd = hd.vmerge + static_cast<size_t>(step - act_start) * m;
    } else {
      kd = a.ck + (hd.kmain - a.ck) + static_cast<size_t>(step) * m;
      vd = a.cv + (hd.vmain - a.cv) + static_cast<size_t>(step) * m;
    }
    quantize_fresh_row(a.kh + row * m, a.vh + row * m, kd, vd, hd.ksrow + step,
                       hd.vsrow + step, m, red);
  }

  // q's terms, the scores' B operand: k-step t holds d 16 t .. 16 t + 15, its
  // k index 2 tq + i taking d 16 t + 4 tq + i and 2 tq + 8 + i taking d 16 t
  // + 4 tq + 2 + i (i = 0, 1), as the A fragments' codes lie; column g =
  // term g. The same loads give this lane's quarter of the fresh position's
  // q . kh (f32 fmaf chain, then the quad's butterfly).
  uint32_t qb[kDT][2];
  float fdot = 0.f;
  int qsh;  // q's shift
  {
    const float* qh = a.q + hd.qoff + 4 * tq;
    const float* khh = a.kh + hd.qoff + 4 * tq;
    float4 qv[kDT];
    float qmax = 0.f;
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      qv[t] = *reinterpret_cast<const float4*>(qh + 16 * t);
      qmax = fmaxf(qmax, fmaxf(fmaxf(fabsf(qv[t].x), fabsf(qv[t].y)),
                               fmaxf(fabsf(qv[t].z), fabsf(qv[t].w))));
    }
    qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, 1));
    qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, 2));
    qsh = f16_shift(qmax);
    const float qup = pow2(qsh);
#pragma unroll
    for (int t = 0; t < kDT; ++t) {
      const float4 k4 = *reinterpret_cast<const float4*>(khh + 16 * t);
      fdot = fmaf(qv[t].x, k4.x, fdot);
      fdot = fmaf(qv[t].y, k4.y, fdot);
      fdot = fmaf(qv[t].z, k4.z, fdot);
      fdot = fmaf(qv[t].w, k4.w, fdot);
      qb[t][0] = f16_term(qv[t].x * qup, g) | (f16_term(qv[t].y * qup, g) << 16);
      qb[t][1] = f16_term(qv[t].z * qup, g) | (f16_term(qv[t].w * qup, g) << 16);
    }
    fdot += __shfl_xor_sync(0xffffffffu, fdot, 1);
    fdot += __shfl_xor_sync(0xffffffffu, fdot, 2);
  }
  const float qdown = pow2(-qsh);
  const float s_fresh = msk[step] ? fdot / a.scale : -INFINITY;

  float acc[kDT][4];  // the value products' accumulators: d row, term column
#pragma unroll
  for (int t = 0; t < kDT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  }
  float m_run = -INFINITY;  // this warp's running max and denominator
  float l_run = 0.f;
  // ldmatrix rows: lane L gives row (L & 7) + 8 ((L >> 3) & 1) of a tile, 16 (L >> 4) bytes in
  const uint32_t lrow = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kPitch + 16 * (lane >> 4);
  for (int i = 0; i < mine; ++i) {
    if (i + kStages - 1 < mine) issue(i + kStages - 1);  // into the slot tile i - 1 used
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile i has landed
    __syncwarp();
    const int p0 = kI8Tile * (warp + kWarps * i);
    const uint32_t slot_s = ring_s + (i % kStages) * kSlot;
    const unsigned char* slot = ring + (i % kStages) * kSlot;
    const float* ksc = reinterpret_cast<const float*>(slot + 2 * kI8Tile * kPitch);
    const float* vsc = ksc + kI8Tile;

    // Scores: C (positions x term columns) = codes . q terms; row g of the
    // A fragments is position g, g + 8 the second half.
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kDT; t += 2) {
      uint32_t r[4];
      ldsm_x4(slot_s + lrow + 16 * t, r);  // k-step t: r0 (rows 0-7), r1 (8-15); t + 1: r2, r3
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t w0 = r[2 * h] ^ 0x80808080u, w1 = r[2 * h + 1] ^ 0x80808080u;
        const uint32_t af[4] = {codes_f16x2(w0, 0x4140u), codes_f16x2(w1, 0x4140u),
                                codes_f16x2(w0, 0x4342u), codes_f16x2(w1, 0x4342u)};
        mma_f16(c, af, qb[t + h][0], qb[t + h][1]);
      }
    }
    // lanes tq = 0 hold columns 0, 1 of positions g and g + 8; column 2 is the next lane's 0
    const float t2a = __shfl_down_sync(0xffffffffu, c[0], 1);
    const float t2b = __shfl_down_sync(0xffffffffu, c[2], 1);
    float sa = -INFINITY, sb = -INFINITY;  // the scores of positions p0 + g, p0 + g + 8
    if (tq == 0) {
      const int pa = p0 + g, pb = pa + 8;
      if (pa < step && msk[pa]) sa = ((t2a + c[1]) + c[0]) * qdown * ksc[g] / a.scale;
      if (pb < step && msk[pb]) sb = ((t2b + c[3]) + c[2]) * qdown * ksc[g + 8] / a.scale;
    }
    const float m_new = fmaxf(m_run, warp_max(fmaxf(sa, sb)));
    const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - m_new);
    const float wa = sa == -INFINITY ? 0.f : expf(sa - m_new);
    const float wb = sb == -INFINITY ? 0.f : expf(sb - m_new);
    l_run = fmaf(l_run, alpha, warp_sum(wa + wb));
    m_run = m_new;

    // Values: C (d rows x term columns) = codes^T . weight terms, the weights
    // times v_scale; row g of an m-tile is d 16 t + 2 g, row g + 8 d 16 t + 2 g + 1.
    const float va = wa * vsc[g], vb = wb * vsc[g + 8];
    const float vmax = warp_max(fmaxf(va, vb));
    if (vmax > 0.f) {
      const int vsh = f16_shift(vmax);
      const float vup = pow2(vsh), vdown = pow2(-vsh);
      // column g: term g of positions 2 tq, 2 tq + 1 (b0) and 8 more (b1)
      const float x0 = __shfl_sync(0xffffffffu, va, 8 * tq) * vup;
      const float x1 = __shfl_sync(0xffffffffu, va, 8 * tq + 4) * vup;
      const float x2 = __shfl_sync(0xffffffffu, vb, 8 * tq) * vup;
      const float x3 = __shfl_sync(0xffffffffu, vb, 8 * tq + 4) * vup;
      const uint32_t b0 = f16_term(x0, g) | (f16_term(x1, g) << 16);
      const uint32_t b1 = f16_term(x2, g) | (f16_term(x3, g) << 16);
#pragma unroll
      for (int t = 0; t < kDT; t += 2) {
        uint32_t r[4];
        ldsm_x4_trans(slot_s + kI8Tile * kPitch + lrow + 16 * t, r);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t w0 = r[2 * h] ^ 0x80808080u, w1 = r[2 * h + 1] ^ 0x80808080u;
          const uint32_t af[4] = {codes_f16x2(w0, 0x4240u), codes_f16x2(w0, 0x4341u),
                                  codes_f16x2(w1, 0x4240u), codes_f16x2(w1, 0x4341u)};
          float cv[4] = {0.f, 0.f, 0.f, 0.f};
          mma_f16(cv, af, b0, b1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t + h][e] = fmaf(cv[e], vdown, acc[t + h][e] * alpha);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < kDT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] *= alpha;
      }
    }
    if constexpr (kPaged) {  // the parent's active positions of this tile, to the merged page
      const int lo = max(p0, act_start), hi = min(p0 + kI8Tile, step);
      for (int x = lane; x < 2 * (hi - lo) * kDT; x += 32) {
        const bool is_v = x >= (hi - lo) * kDT;
        const int y = is_v ? x - (hi - lo) * kDT : x;
        const int p = lo + y / kDT, j = y % kDT;
        *reinterpret_cast<uint4*>((is_v ? hd.vmerge : hd.kmerge) +
                                  static_cast<size_t>(p - act_start) * m + 16 * j) =
            *reinterpret_cast<const uint4*>(slot + (is_v ? kI8Tile * kPitch : 0) +
                                            (p - p0) * kPitch + 16 * j);
      }
    }
    __syncwarp();  // the slot is read: the next issue may refill it
  }
  cp_async_wait<0>();

  // This warp's partial (the terms' sums (t2 + t1) + t0 by d, its max and
  // denominator) into its own ring; then the block merges the warps' and the
  // fresh position's in that order.
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int t = 0; t < kDT; ++t) {
    const float e2 = __shfl_down_sync(0xffffffffu, acc[t][0], 1);
    const float o2 = __shfl_down_sync(0xffffffffu, acc[t][2], 1);
    if (tq == 0) {
      part[16 * t + 2 * g] = (e2 + acc[t][1]) + acc[t][0];
      part[16 * t + 2 * g + 1] = (o2 + acc[t][3]) + acc[t][2];
    }
  }
  if (lane == 0) {
    part[kD] = m_run;
    part[kD + 1] = l_run;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kD; d += kThreads) {
    float mx = s_fresh;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mx = fmaxf(mx, reinterpret_cast<const float*>(smem + w * kStages * kSlot)[kD]);
    }
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = reinterpret_cast<const float*>(smem + w * kStages * kSlot);
      const float f = pw[kD] == -INFINITY ? 0.f : expf(pw[kD] - mx);
      num = fmaf(f, pw[d], num);
      den = fmaf(f, pw[kD + 1], den);
    }
    const float ff = s_fresh == -INFINITY ? 0.f : expf(s_fresh - mx);
    num = fmaf(ff, a.vh[hd.qoff + d], num);
    den += ff;
    store_out(out + hd.qoff + d, den > 0.f ? num / den : 0.f);
  }
}

// K4 / K6's body for one (row, head) work item of an f32 or bf16 cache:
// positions streamed in chunks of kChunk with an online softmax. Called by
// all kThreads threads of a block; writes the head's d_head outputs to `out`
// (f32, or bf16 for K7's out-projection). Shared memory `smem`:
// chunked_smem_floats floats (+ u / page owners), whatever U is. K7
// (csrc/lm_megastep.cu) runs it, through attn_step_chunked_item, for every
// item of a layer's attention phase.
//
// Per chunk: the score pass maps lanes to (position, 16-byte vector) in
// groups of score_group(nvec) lanes, each thread issuing kUnroll positions'
// loads before using any; each warp's maximum goes to shared memory; after
// one barrier every thread takes the chunk's maximum from those, the
// weights are exponentiated in place, and after a second barrier one thread
// sums them (in position order) while the value groups accumulate, again
// with kUnroll positions' loads ahead. Scores, weights and maxima are
// double-buffered by chunk parity, so a chunk needs two barriers. Paged, the
// parent's active positions are copied to the merged page by the passes
// that read them (k by the score pass, v by the value pass, masked ones
// too), so the active page crosses L2 once where a copy ahead of the passes
// read it twice.
//
// Every sum is taken in the order of the design before it (one warp per
// position, every thread scanning the chunk), so K4 and K6 give the same bits
// as before: a dot product is per-lane fmaf chains then the xor butterfly
// (a group's butterfly over offsets group / 2 .. 1 is the warp's over 16 .. 1
// less additions of exact zeros from lanes past nvec), the chunk's sum runs
// in position order, and the groups' value partials are summed in group
// order; a maximum is exact in any order.
template <typename T, bool kPaged, typename TO>
__device__ __forceinline__ void attn_step_chunked_f(const Args<T>& a, unsigned item, float* smem,
                                                    TO* out) {
  constexpr int V = Vec<T>::kN;
  constexpr int kUnroll = 2;  // positions' loads in flight a thread (4 measured slower)
  const int nvec = a.d_head / V;
  const int groups = kThreads / nvec;  // value groups of nvec threads
  float* sbuf = smem;                  // [2][kChunk] scores, then weights
  float* red = sbuf + 2 * kChunk;      // [2][kWarps] the warps' chunk maxima
  float* denom = red + 2 * kWarps;     // [1] the softmax denominator
  float* part = denom + 1;             // [groups][d_head]
  int* owners = reinterpret_cast<int*>(part + groups * a.d_head);  // paged: [u / page]
  load_owners<T, kPaged>(a, owners, item);
  const Head<T, kPaged> hd(a, owners, item, false);
  const int step = a.step;
  // paged: positions act_start .. step - 1 are the parent's active page, which
  // the passes copy to the merged page as they read it (masked ones too)
  const int act_start = kPaged ? hd.act_start : step;

  // score lanes: this lane's vector j of the head, and the first position
  const int grp = score_group(nvec);
  const int per_pass = kThreads / grp;  // positions scored at once by the block
  const int js = hd.lane % grp;
  const bool live = js < nvec;
  const int first = threadIdx.x / grp;
  float qv[V];
  if (live) load_fresh<T>(a.q + hd.qoff + js * V, qv);
  // value lanes
  const int g = threadIdx.x / nvec;
  const int jv = threadIdx.x % nvec;
  const bool sums = threadIdx.x == kThreads - 1;  // the thread that keeps the denominator

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;  // running max: the same in every thread
  float l_run = 0.f;        // running denominator: thread `sums` only

  for (int c0 = 0, par = 0; c0 <= step; c0 += kChunk, par ^= 1) {
    const int cn = min(kChunk, step + 1 - c0);
    float* s = sbuf + par * kChunk;
    float lmax = -INFINITY;
    for (int i0 = 0; i0 < cn; i0 += per_pass * kUnroll) {
      uint4 kr[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + first + u * per_pass;
        const int p = c0 + i;
        ok[u] = i < cn && hd.mrow[p];  // masked positions never reach the sums
        if (live && (ok[u] || (i < cn && p >= act_start)) && p != step) {
          kr[u] = *reinterpret_cast<const uint4*>(hd.at(p, false) + js * V);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + first + u * per_pass;
        if (live && i < cn && c0 + i >= act_start && c0 + i < step) {
          *reinterpret_cast<uint4*>(hd.kmerge + static_cast<size_t>(c0 + i - act_start) * hd.m +
                                    js * V) = kr[u];
        }
        float dot = 0.f;
        if (live && ok[u]) {
          float kx[V];
          if (c0 + i == step) {
            load_fresh<T>(a.kh + hd.qoff + js * V, kx);
          } else {
            unpack(kr[u], kx);
          }
#pragma unroll
          for (int e = 0; e < V; ++e) dot = fmaf(qv[e], kx[e], dot);
        }
        for (int off = grp >> 1; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (i < cn) {
          const float sc = ok[u] ? dot / a.scale : -INFINITY;
          if (js == 0) s[i] = sc;
          lmax = fmaxf(lmax, sc);
        }
      }
    }
    lmax = warp_max(lmax);
    if (hd.lane == 0) red[par * kWarps + hd.warp] = lmax;
    __syncthreads();  // the scores and the warps' maxima
    float cmax = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) cmax = fmaxf(cmax, red[par * kWarps + w]);
    // nothing valid yet gives new_m = -inf: every weight, alpha and the sums
    // stay 0 (the chunk still runs, for the active page's copy)
    const float new_m = fmaxf(m_run, cmax);
    const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - new_m);
    for (int i = threadIdx.x; i < cn; i += kThreads) {
      s[i] = s[i] == -INFINITY ? 0.f : expf(s[i] - new_m);
    }
    __syncthreads();  // the weights
    if (sums) {
      float csum = 0.f;
      for (int i = 0; i < cn; ++i) csum += s[i];
      l_run = l_run * alpha + csum;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] *= alpha;
    if (g < groups) {
      for (int i0 = g; i0 < cn; i0 += groups * kUnroll) {
        uint4 vr[kUnroll];
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * groups;
          const int p = c0 + i;
          w[u] = i < cn ? s[i] : 0.f;  // 0 where masked: skipped
          if ((w[u] != 0.f || (i < cn && p >= act_start)) && p != step) {
            vr[u] = *reinterpret_cast<const uint4*>(hd.at(p, true) + jv * V);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = c0 + i0 + u * groups;
          if (i0 + u * groups < cn && p >= act_start && p < step) {
            *reinterpret_cast<uint4*>(hd.vmerge + static_cast<size_t>(p - act_start) * hd.m +
                                      jv * V) = vr[u];
          }
          if (w[u] != 0.f) {
            float vx[V];
            if (c0 + i0 + u * groups == step) {
              load_fresh<T>(a.vh + hd.qoff + jv * V, vx);
            } else {
              unpack(vr[u], vx);
            }
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] = fmaf(w[u], vx[e], acc[e]);
          }
        }
      }
    }
    m_run = new_m;
    // no barrier: the next chunk writes the other buffers, and the one after
    // comes past the next chunk's barriers, which every thread reaches only
    // when done with this chunk
  }
  if (sums) *denom = l_run;
  __syncthreads();  // the denominator
  finish<V>(acc, *denom, part, g, groups, jv, a.d_head, out + hd.qoff);
}

template <typename T, bool kPaged, typename TO>
__device__ __forceinline__ void attn_step_chunked_item(const Args<T>& a, unsigned item, float* smem,
                                                       TO* out) {
  if constexpr (Vec<T>::kQuant) {  // int8: chunked_i8_smem(d_head, i8_stages(d_head / 16), ...)
    unsigned char* bytes = reinterpret_cast<unsigned char*>(smem);
    switch (a.d_head) {
      case 32: attn_step_chunked_i8<kPaged, 2, i8_stages(2)>(a, item, bytes, out); break;
      case 64: attn_step_chunked_i8<kPaged, 4, i8_stages(4)>(a, item, bytes, out); break;
      case 96: attn_step_chunked_i8<kPaged, 6, i8_stages(6)>(a, item, bytes, out); break;
      case 128: attn_step_chunked_i8<kPaged, 8, i8_stages(8)>(a, item, bytes, out); break;
      default: break;  // refused by the launches and their wrappers
    }
  } else {
    attn_step_chunked_f<T, kPaged>(a, item, smem, out);
  }
}

}  // namespace

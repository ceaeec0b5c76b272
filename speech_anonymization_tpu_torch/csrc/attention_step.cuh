// The device code that the single-token attention kernels share: K3-K6 of
// csrc/attention_step.cu and the attention phase of K7 (csrc/lm_megastep.cu).
// Numerics, addressing and design are stated in csrc/attention_step.cu's
// header. Each (row, head) pair is one work item of 128 threads; K4-K6 run
// one item per block, K3 and K7 walk many items per block.

#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder comes from the runtime)
#include <cuda_bf16.h>
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

// 16 bytes of cache elements -> floats
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 16 int8 codes -> floats, each dequantized as code * scale in f32 (the
// int8 contract: no product before the dequantization)
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[16], float scale) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu)) * scale;
  }
}
// The same, K3's way: each code made a float exactly as (2^23 + code + 128)
// - (2^23 + 128), its bits assembled by a byte permute, where unpack's
// integer-to-float conversions run at an eighth of the FMA rate (3-8%
// faster K3 on an H100). The redesigned K4-K7 keep unpack, as measured.
__device__ __forceinline__ void unpack_codes(const uint4& r, float (&x)[16], float scale) {
  const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                         r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    x[i] = (__uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7540u | (i % 4))) - 8388736.f) *
           scale;
  }
}
__device__ __forceinline__ void load_vec(const int8_t* p, float (&x)[16], float scale) {
  unpack(*reinterpret_cast<const uint4*>(p), x, scale);
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
  float qv[V], kv[V];  // fresh q and k of this lane's vector

  // copy: the paged constructor copies the parent's active positions to the
  // merged page itself (K5); K6's body copies them as its passes read them.
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
    if (live) {
      load_fresh<T>(a.q + qoff + lane * V, qv);
      load_fresh<T>(a.kh + qoff + lane * V, kv);
    }
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
      // the quantizer's amax spans the row's M values (every head): warp 0
      // reduces kh's, warp 1 vh's, each reading the whole row itself, so no
      // second launch and no cross-block exchange. A max is exact in any
      // order, so every head's block gets the same scale, bit for bit; the
      // row's head-0 block writes the scales at (layer, row, step).
      if (warp < 2) {
        const float* fresh = warp == 0 ? a.kh : a.vh;
        const float* src = fresh + static_cast<size_t>(row) * m;
        float amax = 0.f;
        for (int i = 4 * lane; i < m; i += 128) {
          const float4 v = *reinterpret_cast<const float4*>(src + i);
          amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
        }
        amax = fmaxf(warp_max(amax), 1e-6f);
        if (live) {
          float x[V];
          load_fresh<T>(fresh + qoff + lane * V, x);
          store_codes((warp == 0 ? kdst : vdst) + lane * V, x, 127.f / amax);  // IEEE division
        }
        if (lane == 0 && item % nhead == 0) {
          (warp == 0 ? ksrow : vsrow)[a.step] = amax / 127.f;
        }
      }
    } else {
      if (warp == 0 && live) store_vec(kdst + lane * V, kv);
      if (warp == 1 && live) {
        float vv[V];
        load_fresh<T>(a.vh + qoff + lane * V, vv);
        store_vec(vdst + lane * V, vv);
      }
    }
  }

  // 16 bytes of position p < step of this row and head, lane vector j, as
  // floats (int8: dequantized with the position's scale)
  __device__ __forceinline__ void load_at(int p, bool is_v, int j, float (&x)[V]) const {
    if constexpr (Vec<T>::kQuant) {
      load_vec(at(p, is_v) + j * V, x, (is_v ? vsrow : ksrow)[p]);
    } else {
      load_vec(at(p, is_v) + j * V, x);
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

  // Scaled score of position p (called by a whole warp), -inf where masked.
  __device__ __forceinline__ float score(int p, int step, float scale) const {
    if (!mrow[p]) return -INFINITY;  // warp-uniform: the cache is not read
    float dot = 0.f;
    if (live) {
      if (p == step) {
#pragma unroll
        for (int i = 0; i < V; ++i) dot = fmaf(qv[i], kv[i], dot);
      } else {
        float kx[V];
        load_at(p, false, lane, kx);
#pragma unroll
        for (int i = 0; i < V; ++i) dot = fmaf(qv[i], kx[i], dot);
      }
    }
    return warp_sum(dot) / scale;
  }

  // acc += w * v[p] for this thread's vector j of the head
  __device__ __forceinline__ void add_value(float (&acc)[V], float w, int p, int step, int j,
                                            const float* vh) const {
    float vx[V];
    if (p == step) {
      load_fresh<T>(vh + qoff + j * V, vx);
    } else {
      load_at(p, true, j, vx);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(w, vx[i], acc[i]);
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

// K4 / K6's body for one (row, head) work item: positions streamed in
// chunks of kChunk with an online softmax. Called by all kThreads threads of
// a block; writes the head's d_head outputs to `out` (f32, or bf16 for K7's
// out-projection). Shared memory `smem`: chunked_smem_floats floats (+ u /
// page owners), whatever U is. K7 (csrc/lm_megastep.cu) runs it for every
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
// int8 (K4, K6, K7 on int8 caches): each thread reads the own-row scale of a
// position beside its 16 codes, only where the position is valid and before
// the step (a masked or later position's scale may be NaN), and dequantizes
// code * scale before any product; the parent's active codes go to the
// merged page as bytes, and no scale moves (the beam reorder gathers them
// along N). Head's constructor quantizes the fresh k/v into the merged page.
//
// Every sum is taken in the order of the design before it (one warp per
// position, every thread scanning the chunk), so K4 and K6 give the same bits
// as before: a dot product is per-lane fmaf chains then the xor butterfly
// (a group's butterfly over offsets group / 2 .. 1 is the warp's over 16 .. 1
// less additions of exact zeros from lanes past nvec), the chunk's sum runs
// in position order, and the groups' value partials are summed in group
// order; a maximum is exact in any order.
template <typename T, bool kPaged, typename TO>
__device__ __forceinline__ void attn_step_chunked_item(const Args<T>& a, unsigned item, float* smem,
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
      float ksc[kUnroll];  // int8: the positions' scales
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + first + u * per_pass;
        const int p = c0 + i;
        ok[u] = i < cn && hd.mrow[p];  // masked positions never reach the sums
        if (live && (ok[u] || (i < cn && p >= act_start)) && p != step) {
          kr[u] = *reinterpret_cast<const uint4*>(hd.at(p, false) + js * V);
        }
        if constexpr (Vec<T>::kQuant) {
          if (live && ok[u] && p != step) ksc[u] = hd.ksrow[p];  // never a masked one's
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
          } else if constexpr (Vec<T>::kQuant) {
            unpack(kr[u], kx, ksc[u]);
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
        float vsc[kUnroll];  // int8: the positions' scales
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * groups;
          const int p = c0 + i;
          w[u] = i < cn ? s[i] : 0.f;  // 0 where masked: skipped
          if ((w[u] != 0.f || (i < cn && p >= act_start)) && p != step) {
            vr[u] = *reinterpret_cast<const uint4*>(hd.at(p, true) + jv * V);
          }
          if constexpr (Vec<T>::kQuant) {
            if (w[u] != 0.f && p != step) vsc[u] = hd.vsrow[p];
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
            } else if constexpr (Vec<T>::kQuant) {
              unpack(vr[u], vx, vsc[u]);
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

}  // namespace

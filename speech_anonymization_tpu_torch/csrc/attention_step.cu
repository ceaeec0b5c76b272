// Single-token cached self-attention of one decoder layer, for Hopper
// (sm_90a): the beam-decode step's attention against the stacked KV cache,
// physical (K3, K4) or paged (K5, K6).
//
// Replaces the Pallas TPU kernels of
// speech_anonymization_tpu/ops/pallas/attention_step.py:
//   K3 `_kernel` and K4 `_kernel_chunked` (launched by `_attn_step_call`,
//     physical caches): U within the TPU's VMEM budget is held whole, longer
//     U is streamed with an online softmax;
//   K5 `_kernel_paged` and K6 `_kernel_chunked_paged` (launched by
//     `_attn_step_paged_call` and `_attn_step_paged_fused_call`, paged caches:
//     the lazy beam reorder).
// Here they are `attn_step_whole_row` and `attn_step_chunked`, each
// instantiated with physical (kPaged = false: K3, K4) or paged (kPaged =
// true: K5, K6) addressing. For row n, head h and layer `layer`:
//
//     s_p  = q_h . k_h[p] / sqrt(d_head)    p <= step with mask[n, p] != 0
//     out  = sum_p softmax(s)_p v_h[p]      (N, M) f32, heads concatenated
//
// where position `step` takes the fresh kh/vh. Cache positions > step and
// masked positions are never read, so stale, NaN or Inf bytes there (a
// reorder leaves positions > step undefined; buffers may come from
// torch.empty) cannot reach the output: they are excluded before any
// multiply, not weighted by 0. A row with no valid position gets out = 0
// (the TPU kernel's clamped denominator gives the same); decode never makes
// one, since position 0 holds bos.
//
// Where position p of row n lives, and what is written IN PLACE (the TPU
// outputs alias the cache):
//   physical: at (layer, n, p); the fresh k/v are written at (layer, n, step).
//   paged: completed page p / page at row table[n, p / page] of the main
//     cache; the active page (the one holding `step`) at parity slot
//     (step + 1) % 2 of row act_src[n], the beam parent, which wrote it at
//     step - 1. The split layout keeps k and v caches (L, N, U, M) and slots
//     (L, N, 2, page, M); the fused layout one cache (L, N, 2U, M) whose
//     logical page is [K-page, V-page] and slots (L, N, 2, 2 page, M). Each
//     block writes its head's slice of the MERGED active page (the parent's
//     positions from (step / page) * page up to step - 1, copied as bytes,
//     then the fresh k/v at step) to its OWN row: slot step % 2, or main page
//     step / page when step % page == page - 1 completes it. Blocks read
//     only slot (step + 1) % 2 and pages below step / page, and write only
//     slot step % 2 or page step / page, so the in-place writes cannot race.
//     The beam reorder then moves no k/v: it gathers the int table.
//
// Numerics. f32 caches compute in f32 throughout, against the JAX
// package's reference math (`MultiHeadAttention.attend_cached`, the path
// JAX runs off the TPU): the TPU kernel's bf16 rounding of q/kh/vh and of
// k in the scores is a concession to its matrix unit, not the contract.
// bf16 caches follow the TPU kernel's contract: q, kh and vh are rounded to
// bf16 on entry, the cache is read as bf16, and every product and sum is
// f32. int8 caches are not supported (the wrappers refuse them). Paged and
// physical addressing of the same content give bit-identical outputs.
//
// Bound: each launch must read the live cache of its layer, k and v, at
// the valid positions (2 * N * (step + 1) * M * itemsize bytes at most:
// 3.24 MB * (step + 1) at N 528, M 768, f32; beams that share a completed
// page share its bytes); the arithmetic (4 flops per cached element) is far
// below the card's rate, so it is bound by device-memory bandwidth. The
// paged kernels also write the merged active page, up to page positions of
// k and v per row.
//
// Design: one block of 128 threads per (row, head); d_head = 96 gives
// N * H = 4,224 blocks at the decode shape. A head's slice of one position
// is d_head contiguous elements (384 B in f32), read as 16-byte vectors by
// consecutive lanes. Scores: each warp takes one position at a time and
// reduces its dot product with shuffles. Values: the block splits into
// groups of d_head / vec threads, each group summing every groups-th
// position, then the groups are summed through shared memory. The TPU
// kernels' devices (the (M, H) head-segment matmul, the optimistic fresh-
// token seed removed at the end, per-(row, page) DMA descriptors and the
// uniform-owner tile flag) exist because the TPU cannot index lanes or
// addresses dynamically; here the fresh token's mask bit is read directly
// and a position's address is computed per load, the row's page owners held
// in shared memory. The paged block copies the parent's active positions
// first; the score pass then finds them in L2.
//   attn_step_whole_row keeps the step + 1 scores in shared memory (U
//     floats) and does an exact softmax.
//   attn_step_chunked streams positions in chunks of 64 with a running
//     max, denominator and accumulator (flash-decoding), so its shared
//     memory does not depend on U.
// Limits checked by the Python wrappers: d_head a multiple of the vector
// width (4 f32 or 8 bf16 elements) and at most 32 vectors, 16-byte aligned
// operands, 0 <= step < U, 0 <= layer < L, a power-of-two page dividing U.
// table and act_src must hold rows in [0, N) (the beam reorder builds them
// from in-range parents).

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
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
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
};

// What both kernels share for one (row, head) block: the fresh operands,
// the address of any position of the row, and (in the constructor) the
// in-place writes.
template <typename T, bool kPaged>
struct Head {
  static constexpr int V = Vec<T>::kN;
  const T* kmain;  // physical: this row's position 0; paged: the layer's row 0
  const T* vmain;  //   (all with this head's offset)
  const T* kact;   // paged: the parent's read slot at the first active position
  const T* vact;
  const int* owners;  // paged: shared memory, the owner row of each completed page
  const unsigned char* mrow;  // mask row
  size_t qoff;        // offset of this head in the (N, M) operands
  size_t row_stride;  // paged: elements between rows of the main cache
  int m, nvec, lane, warp;
  int act_start, page_shift, page_pos;  // paged
  bool live;          // lane < nvec: holds a vector of the head
  float qv[V], kv[V];  // fresh q and k of this lane's vector

  __device__ Head(const Args<T>& a, const int* owners_) : owners(owners_), m(a.m) {
    const int nhead = m / a.d_head;
    const int row = blockIdx.x / nhead;
    const size_t hoff = static_cast<size_t>(blockIdx.x % nhead) * a.d_head;
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
      // the parent's positions act_start .. step - 1, k then v, as bytes
      const int span = o * nvec;
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
    if (warp == 0 && live) store_vec(kdst + lane * V, kv);
    if (warp == 1 && live) {
      float vv[V];
      load_fresh<T>(a.vh + qoff + lane * V, vv);
      store_vec(vdst + lane * V, vv);
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
        load_vec(at(p, false) + lane * V, kx);
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
      load_vec(at(p, true) + j * V, vx);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(w, vx[i], acc[i]);
  }
};

// Paged: the row's completed-page owners into shared memory.
template <typename T, bool kPaged>
__device__ __forceinline__ void load_owners(const Args<T>& a, int* owners) {
  if constexpr (kPaged) {
    const int row = blockIdx.x / (a.m / a.d_head);
    const int up = a.u >> a.page_shift;
    const int done = a.step >> a.page_shift;
    for (int i = threadIdx.x; i < done; i += kThreads) {
      owners[i] = a.table[static_cast<size_t>(row) * up + i];
    }
    __syncthreads();
  }
}

// Sum the groups' partial value vectors and write out = total / denom.
template <int V>
__device__ __forceinline__ void finish(const float (&acc)[V], float denom, float* part, int g,
                                       int groups, int j, int d_head, float* out) {
  if (g < groups) {
#pragma unroll
    for (int i = 0; i < V; ++i) part[g * d_head + j * V + i] = acc[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < d_head; d += kThreads) {
    float tot = 0.f;
    for (int gg = 0; gg < groups; ++gg) tot += part[gg * d_head + d];
    out[d] = denom > 0.f ? tot / denom : 0.f;
  }
}

// K3 / K5: the step + 1 scores live in shared memory; exact two-pass softmax.
// Shared memory: u + kWarps + groups * d_head floats (+ u / page owners).
template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads) attn_step_whole_row(const Args<T> a) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ float smem[];
  const int groups = kThreads / (a.d_head / V);
  float* s = smem;             // [u] scores, then weights
  float* red = s + a.u;        // [kWarps]
  float* part = red + kWarps;  // [groups][d_head]
  int* owners = reinterpret_cast<int*>(part + groups * a.d_head);  // paged: [u / page]
  load_owners<T, kPaged>(a, owners);
  const Head<T, kPaged> hd(a, owners);
  const int step = a.step;

  for (int p = hd.warp; p <= step; p += kWarps) {
    const float sc = hd.score(p, step, a.scale);
    if (hd.lane == 0) s[p] = sc;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int p = threadIdx.x; p <= step; p += kThreads) mx = fmaxf(mx, s[p]);
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int p = threadIdx.x; p <= step; p += kThreads) {
    const float e = s[p] == -INFINITY ? 0.f : expf(s[p] - mx);
    s[p] = e;
    sum += e;
  }
  sum = block_sum(sum, red);  // its barriers publish the weights

  const int g = threadIdx.x / hd.nvec;
  const int j = threadIdx.x % hd.nvec;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (g < groups) {
    for (int p = g; p <= step; p += groups) {
      const float w = s[p];
      if (w != 0.f) hd.add_value(acc, w, p, step, j, a.vh);
    }
  }
  finish<V>(acc, sum, part, g, groups, j, a.d_head, a.out + hd.qoff);
}

// K4 / K6: positions streamed in chunks of kChunk with an online softmax.
// Shared memory: kChunk + kWarps + groups * d_head floats (+ u / page
// owners), whatever U is.
template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads) attn_step_chunked(const Args<T> a) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ float smem[];
  const int groups = kThreads / (a.d_head / V);
  float* s = smem;                    // [kChunk]
  float* part = s + kChunk + kWarps;  // [groups][d_head]
  int* owners = reinterpret_cast<int*>(part + groups * a.d_head);  // paged: [u / page]
  load_owners<T, kPaged>(a, owners);
  const Head<T, kPaged> hd(a, owners);
  const int step = a.step;

  const int g = threadIdx.x / hd.nvec;
  const int j = threadIdx.x % hd.nvec;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  float m_run = -INFINITY;  // running max, denominator: the same in every thread
  float l_run = 0.f;

  for (int c0 = 0; c0 <= step; c0 += kChunk) {
    const int cn = min(kChunk, step + 1 - c0);
    for (int i = hd.warp; i < cn; i += kWarps) {
      const float sc = hd.score(c0 + i, step, a.scale);
      if (hd.lane == 0) s[i] = sc;
    }
    __syncthreads();
    float cmax = -INFINITY;
    for (int i = 0; i < cn; ++i) cmax = fmaxf(cmax, s[i]);
    const float new_m = fmaxf(m_run, cmax);
    __syncthreads();  // every thread has read the scores
    if (new_m == -INFINITY) continue;  // nothing valid yet (block-uniform)
    const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - new_m);
    for (int i = threadIdx.x; i < cn; i += kThreads) {
      s[i] = s[i] == -INFINITY ? 0.f : expf(s[i] - new_m);
    }
    __syncthreads();
    float csum = 0.f;
    for (int i = 0; i < cn; ++i) csum += s[i];
    l_run = l_run * alpha + csum;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] *= alpha;
    if (g < groups) {
      for (int i = g; i < cn; i += groups) {
        const float w = s[i];
        if (w != 0.f) hd.add_value(acc, w, c0 + i, step, j, a.vh);
      }
    }
    m_run = new_m;
    __syncthreads();  // the weights are consumed before the next chunk's scores
  }
  finish<V>(acc, l_run, part, g, groups, j, a.d_head, a.out + hd.qoff);
}

template <typename T, bool kPaged>
int launch(const Args<T>& a, int nhead, int chunked, int device, cudaStream_t stream) {
  const int groups = kThreads / (a.d_head / Vec<T>::kN);
  const int scores = chunked ? kChunk : a.u;
  const int owners = kPaged ? (a.u >> a.page_shift) : 0;
  const size_t smem =
      (static_cast<size_t>(scores) + kWarps + static_cast<size_t>(groups) * a.d_head) *
          sizeof(float) +
      static_cast<size_t>(owners) * sizeof(int);
  auto kernel = chunked ? attn_step_chunked<T, kPaged> : attn_step_whole_row<T, kPaged>;
  // Above the default 48 KB (K3 at U beyond ~11,800 positions) the kernel's
  // dynamic shared-memory limit is raised, once per device, kernel and size.
  static int smem_set[kMaxDevices][2] = {};
  if (smem > kDefaultSmem) {
    if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    int& set = smem_set[device][chunked ? 1 : 0];
    if (static_cast<int>(smem) > set) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      set = static_cast<int>(smem);
    }
  }
  if (a.n > 0) kernel<<<a.n * nhead, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

template <typename T>
Args<T> make_args(const void* q, const void* kh, const void* vh, const void* mask, void* ck,
                  void* cv, void* out, int n, int u, int m, int nhead, int step, int layer) {
  Args<T> a = {};
  a.q = static_cast<const float*>(q);
  a.kh = static_cast<const float*>(kh);
  a.vh = static_cast<const float*>(vh);
  a.mask = static_cast<const unsigned char*>(mask);
  a.ck = static_cast<T*>(ck);
  a.cv = static_cast<T*>(cv);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.u = u;
  a.m = m;
  a.d_head = m / nhead;
  a.step = step;
  a.layer = layer;
  a.row_pos = u;
  a.scale = sqrtf(static_cast<float>(a.d_head));
  return a;
}

template <typename T>
int launch_paged(const void* q, const void* kh, const void* vh, const void* mask, void* ck,
                 void* cv, void* ak, void* av, const void* table, const void* act_src, void* out,
                 int n, int u, int m, int nhead, int step, int layer, int page, int fused,
                 int chunked, int device, cudaStream_t stream) {
  Args<T> a = make_args<T>(q, kh, vh, mask, ck, cv, out, n, u, m, nhead, step, layer);
  a.ak = static_cast<T*>(ak);
  a.av = static_cast<T*>(av);
  a.table = static_cast<const int*>(table);
  a.act_src = static_cast<const int*>(act_src);
  while ((1 << a.page_shift) < page) ++a.page_shift;
  a.row_pos = fused ? 2 * u : u;
  a.page_pos = fused ? 2 * page : page;
  a.slot_pos = fused ? 2 * page : page;
  a.v_off = fused ? page : 0;
  return launch<T, true>(a, nhead, chunked, device, stream);
}

}  // namespace

extern "C" {

// q, kh, vh, out: (n, m) f32; mask: (n, u) bytes, nonzero = valid key;
// ck, cv: (L, n, u, m) caches, f32 (dtype 0) or bf16 (dtype 1); all
// contiguous on `device`. chunked = 0 launches the whole-row kernel (K3),
// 1 the streamed one (K4). Writes out and the caches' (layer, :, step)
// slices. Launches on `stream` and returns cudaGetLastError() (0 on
// success). Does not synchronise.
int sa_attention_step(const void* q, const void* kh, const void* vh, const void* mask, void* ck,
                      void* cv, void* out, int n, int u, int m, int nhead, int step, int layer,
                      int dtype, int chunked, int device, void* stream) {
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, false>(
        make_args<float>(q, kh, vh, mask, ck, cv, out, n, u, m, nhead, step, layer), nhead,
        chunked, device, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, false>(
        make_args<__nv_bfloat16>(q, kh, vh, mask, ck, cv, out, n, u, m, nhead, step, layer),
        nhead, chunked, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The paged kernels, K5 (chunked = 0) and K6 (chunked = 1). q, kh, vh, out,
// mask as above; u is the logical cache length and page (a power of two)
// divides it. Split layout (fused = 0): ck, cv (L, n, u, m) and ak, av
// (L, n, 2, page, m). Fused layout (fused = 1): ck = cv the (L, n, 2u, m)
// cache and ak = av the (L, n, 2, 2 page, m) slots. table: (n, u / page)
// int32; act_src: (n,) int32. Writes out and this layer's merged active page
// of every row (its parity slot step % 2, or its main page step / page when
// the page completes). Returns cudaGetLastError(); does not synchronise.
int sa_attention_step_paged(const void* q, const void* kh, const void* vh, const void* mask,
                            void* ck, void* cv, void* ak, void* av, const void* table,
                            const void* act_src, void* out, int n, int u, int m, int nhead,
                            int step, int layer, int page, int fused, int dtype, int chunked,
                            int device, void* stream) {
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_paged<float>(q, kh, vh, mask, ck, cv, ak, av, table, act_src, out, n, u, m,
                               nhead, step, layer, page, fused, chunked, device, s);
  }
  if (dtype == 1) {
    return launch_paged<__nv_bfloat16>(q, kh, vh, mask, ck, cv, ak, av, table, act_src, out, n, u,
                                       m, nhead, step, layer, page, fused, chunked, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

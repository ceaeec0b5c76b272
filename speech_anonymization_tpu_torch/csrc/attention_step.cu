// Single-token cached self-attention of one decoder layer, for Hopper
// (sm_90a): the beam-decode step's attention against the stacked KV cache.
//
// Replaces the Pallas TPU kernels K3 and K4 of
// speech_anonymization_tpu/ops/pallas/attention_step.py, both launched by
// `_attn_step_call` (non-paged caches): `_kernel` (whole row, U within the
// TPU's VMEM budget) and `_kernel_chunked` (longer U, streamed with an
// online softmax). Here they are `attn_step_whole_row` and
// `attn_step_chunked`. For row n, head h and layer `layer`:
//
//     s_p  = q_h . k_h[p] / sqrt(d_head)    p <= step with mask[n, p] != 0
//     out  = sum_p softmax(s)_p v_h[p]      (N, M) f32, heads concatenated
//
// where position `step` takes the fresh kh/vh, which are also written into
// the cache at (layer, n, step) IN PLACE (the TPU outputs alias the cache).
// Cache positions > step and masked positions are never read, so stale,
// NaN or Inf bytes there (a beam reorder leaves positions > step undefined;
// spare buffers come from torch.empty) cannot reach the output: they are
// excluded before any multiply, not weighted by 0. A row with no valid
// position gets out = 0 (the TPU kernel's clamped denominator gives the
// same); decode never makes one, since position 0 holds bos.
//
// Numerics. f32 caches compute in f32 throughout, against the JAX
// package's reference math (`MultiHeadAttention.attend_cached`, the path
// JAX runs off the TPU): the TPU kernel's bf16 rounding of q/kh/vh and of
// k in the scores is a concession to its matrix unit, not the contract.
// bf16 caches follow the TPU kernel's contract: q, kh and vh are rounded to
// bf16 on entry, the cache is read as bf16, and every product and sum is
// f32. int8 caches are not supported (the wrapper refuses them).
//
// Bound: each launch must read the live cache of its layer, k and v,
// 2 * N * (step + 1) * M * itemsize bytes (3.24 MB * (step + 1) at N 528,
// M 768, f32); the arithmetic (4 flops per cached element) is far below
// the card's rate, so it is bound by device-memory bandwidth.
//
// Design: one block of 128 threads per (row, head); d_head = 96 gives
// N * H = 4,224 blocks at the decode shape. A head's slice of one position
// is d_head contiguous elements (384 B in f32), read as 16-byte vectors by
// consecutive lanes. Scores: each warp takes one position at a time and
// reduces its dot product with shuffles. Values: the block splits into
// groups of d_head / vec threads, each group summing every groups-th
// position, then the groups are summed through shared memory. The TPU
// kernels' devices (the (M, H) head-segment matmul, the optimistic fresh-
// token seed removed at the end) exist because the TPU cannot index lanes
// dynamically; here the fresh token's mask bit is read directly.
//   attn_step_whole_row keeps the step + 1 scores in shared memory (U
//     floats) and does an exact softmax.
//   attn_step_chunked streams positions in chunks of 64 with a running
//     max, denominator and accumulator (flash-decoding), so its shared
//     memory does not depend on U.
// Limits checked by the Python wrapper: d_head a multiple of the vector
// width (4 f32 or 8 bf16 elements) and at most 32 vectors, 16-byte aligned
// operands, 0 <= step < U, 0 <= layer < L.

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

// What both kernels share for one (row, head) block.
template <typename T>
struct Head {
  static constexpr int V = Vec<T>::kN;
  const T* krow;             // this head's slice of position 0, layer `layer`
  const T* vrow;
  const unsigned char* mrow;  // mask row
  size_t qoff;               // offset of this head in the (N, M) operands
  int m, nvec, lane, warp;
  bool live;                 // lane < nvec: holds a vector of the head
  float qv[V], kv[V];        // fresh q and k of this lane's vector

  __device__ Head(const float* q, const float* kh, const float* vh, const unsigned char* mask,
                  T* ck, T* cv, int n_rows, int u, int m_, int d_head, int step, int layer)
      : m(m_) {
    const int nhead = m / d_head;
    const int row = blockIdx.x / nhead;
    const int head = blockIdx.x % nhead;
    nvec = d_head / V;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    live = lane < nvec;
    qoff = static_cast<size_t>(row) * m + static_cast<size_t>(head) * d_head;
    const size_t base = (static_cast<size_t>(layer) * n_rows + row) * u * m +
                        static_cast<size_t>(head) * d_head;
    krow = ck + base;
    vrow = cv + base;
    mrow = mask + static_cast<size_t>(row) * u;
    if (live) {
      load_fresh<T>(q + qoff + lane * V, qv);
      load_fresh<T>(kh + qoff + lane * V, kv);
    }
    // the fresh k/v land at `step`; no block of this launch reads the cache there
    const size_t at_step = base + static_cast<size_t>(step) * m + lane * V;
    if (warp == 0 && live) store_vec(ck + at_step, kv);
    if (warp == 1 && live) {
      float vv[V];
      load_fresh<T>(vh + qoff + lane * V, vv);
      store_vec(cv + at_step, vv);
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
        load_vec(krow + static_cast<size_t>(p) * m + lane * V, kx);
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
      load_vec(vrow + static_cast<size_t>(p) * m + j * V, vx);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(w, vx[i], acc[i]);
  }
};

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

// K3: the step + 1 scores live in shared memory; exact two-pass softmax.
// Shared memory: u + kWarps + groups * d_head floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_step_whole_row(const float* __restrict__ q, const float* __restrict__ kh,
                    const float* __restrict__ vh, const unsigned char* __restrict__ mask, T* ck,
                    T* cv, float* __restrict__ out, int n_rows, int u, int m, int d_head, int step,
                    int layer, float scale) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ float smem[];
  float* s = smem;          // [u] scores, then weights
  float* red = s + u;       // [kWarps]
  float* part = red + kWarps;  // [groups][d_head]
  const Head<T> hd(q, kh, vh, mask, ck, cv, n_rows, u, m, d_head, step, layer);

  for (int p = hd.warp; p <= step; p += kWarps) {
    const float sc = hd.score(p, step, scale);
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

  const int groups = kThreads / hd.nvec;
  const int g = threadIdx.x / hd.nvec;
  const int j = threadIdx.x % hd.nvec;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (g < groups) {
    for (int p = g; p <= step; p += groups) {
      const float w = s[p];
      if (w != 0.f) hd.add_value(acc, w, p, step, j, vh);
    }
  }
  finish<V>(acc, sum, part, g, groups, j, d_head, out + hd.qoff);
}

// K4: positions streamed in chunks of kChunk with an online softmax.
// Shared memory: kChunk + kWarps + groups * d_head floats, whatever U is.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_step_chunked(const float* __restrict__ q, const float* __restrict__ kh,
                  const float* __restrict__ vh, const unsigned char* __restrict__ mask, T* ck,
                  T* cv, float* __restrict__ out, int n_rows, int u, int m, int d_head, int step,
                  int layer, float scale) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ float smem[];
  float* s = smem;                // [kChunk]
  float* part = s + kChunk + kWarps;  // [groups][d_head]
  const Head<T> hd(q, kh, vh, mask, ck, cv, n_rows, u, m, d_head, step, layer);

  const int groups = kThreads / hd.nvec;
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
      const float sc = hd.score(c0 + i, step, scale);
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
        if (w != 0.f) hd.add_value(acc, w, c0 + i, step, j, vh);
      }
    }
    m_run = new_m;
    __syncthreads();  // the weights are consumed before the next chunk's scores
  }
  finish<V>(acc, l_run, part, g, groups, j, d_head, out + hd.qoff);
}

template <typename T>
int launch(const void* q, const void* kh, const void* vh, const void* mask, void* ck, void* cv,
           void* out, int n, int u, int m, int nhead, int step, int layer, int chunked, int device,
           cudaStream_t stream) {
  const int d_head = m / nhead;
  const int groups = kThreads / (d_head / Vec<T>::kN);
  const int scores = chunked ? kChunk : u;
  const size_t smem = (static_cast<size_t>(scores) + kWarps + static_cast<size_t>(groups) * d_head) *
                      sizeof(float);
  const float scale = sqrtf(static_cast<float>(d_head));
  auto kernel = chunked ? attn_step_chunked<T> : attn_step_whole_row<T>;
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
  if (n > 0) {
    kernel<<<n * nhead, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kh), static_cast<const float*>(vh),
        static_cast<const unsigned char*>(mask), static_cast<T*>(ck), static_cast<T*>(cv),
        static_cast<float*>(out), n, u, m, d_head, step, layer, scale);
  }
  return static_cast<int>(cudaGetLastError());
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
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, kh, vh, mask, ck, cv, out, n, u, m, nhead, step, layer, chunked, device,
                         s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, kh, vh, mask, ck, cv, out, n, u, m, nhead, step, layer, chunked,
                                 device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

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
// Here they are `attn_step_whole_row` (K3), `attn_step_chunked` instantiated
// with physical (kPaged = false: K4) or paged (kPaged = true: K6) addressing,
// and K5's own `attn_step_paged_rows` (design below). Their
// per-(row, head) device code lives in
// csrc/attention_step.cuh, which K7 (csrc/lm_megastep.cu) includes too.
// For row n, head h and layer `layer`:
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
// f32. int8 caches (every kernel here) hold codes with an f32 scale per
// (layer, row, position) in separate (L, N, U) arrays, indexed by the row's
// own logical position in both layouts (paging moves only the code bytes). They follow the JAX
// package's reference math (`attend_cached` + `finalize_jnp`), not the TPU
// kernel's bf16 rounding of q and the dequantized keys: a cached element
// reads as code * scale in f32 before any product, q and the fresh kh/vh stay
// f32, and the rest is the f32 math. Each launch quantizes the fresh row of
// M values (every head) once: amax = max(max |x|, 1e-6), code =
// clip(rint(x * (127 / amax)), -127, 127) (round half to even), scale =
// amax / 127, both divisions IEEE (the build keeps --use_fast_math off);
// the TPU kernel's amax * (1 / 127) can differ in the last bit. Paged and
// physical addressing of the same content give bit-identical outputs.
//
// Bound: each launch must read the live cache of its layer, k and v, at
// the valid positions (2 * N * (step + 1) * M * itemsize bytes at most:
// 3.24 MB * (step + 1) at N 528, M 768, f32; beams that share a completed
// page share its bytes; int8 adds 8 bytes of scales a row and position); the
// arithmetic (4 flops per cached element) is far
// below the card's rate, so it is bound by device-memory bandwidth. The
// paged kernels also write the merged active page, up to page positions of
// k and v per row.
//
// On the card these kernels are bound first by the latency of their
// dependent loads and by L2 traffic: rows that share pages re-read them
// through L2, and each paged row reads and writes its merged page.
//
// Design: one block of 128 threads per (row, head); d_head = 96 gives
// N * H = 4,224 blocks at the decode shape. A head's slice of one position
// is d_head contiguous elements (384 B in f32), read as 16-byte vectors by
// consecutive lanes. Values: the block splits into groups of d_head / vec
// threads, each group summing every groups-th position, then the groups are
// summed through shared memory. The TPU kernels' devices (the (M, H)
// head-segment matmul, the optimistic fresh-token seed removed at the end,
// per-(row, page) DMA descriptors and the uniform-owner tile flag) exist
// because the TPU cannot index lanes or addresses dynamically; here the
// fresh token's mask bit is read directly and a position's address is
// computed per load, the row's page owners held in shared memory.
//   attn_step_whole_row (K3) keeps the step + 1 scores in shared memory (U
//     floats) and does an exact softmax; each warp scores one position at a
//     time, reducing its dot product with shuffles.
//   attn_step_chunked (K4, K6) streams positions in chunks of 64 with a
//     running max, denominator and accumulator (flash-decoding), so its
//     shared memory does not depend on U. Its body
//     (attn_step_chunked_item, csrc/attention_step.cuh, which K7 runs too)
//     maps the score lanes to (position, 16-byte vector) in groups of 8, 16
//     or 32, keeps 2 positions' loads in flight a thread in both passes,
//     takes two barriers a chunk, and copies the parent's active page to
//     the merged page in the passes that read it, so the page crosses L2
//     once; its sums keep the order of the one-warp-a-position design
//     before it, so K4 and K6 give that design's bits, and each other's.
//   attn_step_paged_rows (K5) is the whole-row kernel with its position
//     loops rebuilt, because K3's are bound by load latency, not bytes: a
//     warp scores one position with d_head / vec of its lanes loading (12
//     of 32 for bf16 x 96), a few positions' loads in flight. K5's lanes
//     map to (position, 16-byte vector) in groups of nvec rounded up to 8,
//     16 or 32, so a warp scores 1-4 positions at once, each group's dot
//     product summed by shuffles within the group; every thread issues the
//     loads of 4 positions before using any, in the scores and in the
//     values. On the card this beat K3's loops at every paged shape (PERF.md
//     has the measurements), where staging the pages that rows share in shared memory, one
//     block per page with a merge, and whole pages held in registers lost:
//     each cut the blocks resident per SM or lengthened a block's chain of
//     dependent loads.
//   int8 (K3-K6): a 16-byte vector is 16 codes (d_head 96: 6 vectors, 64:
//     4), each lane dequantizing with its position's scale as it loads. The
//     quantizer's amax spans the whole row while a block holds one head, so
//     in every block warp 0 reads the row's M values of kh and warp 1 those of
//     vh (3 KB each, from L2) and reduce max |x| themselves: a max is exact, so
//     every head's block gets the same scale bit for bit, with no second
//     launch. Each block writes its head's codes; the row's head-0 block
//     writes the two scales. K5's and K4/K6's score groups are 8 lanes with 6
//     or 4 live, and K4/K6's value pass takes 21 or 32 groups of nvec
//     threads (their partials in shared memory: 8 KB a block).
// Limits checked by the Python wrappers: d_head a multiple of the vector
// width (4 f32, 8 bf16 or 16 int8 elements) and at most 32 vectors, 16-byte aligned
// operands, 0 <= step < U, 0 <= layer < L, a power-of-two page dividing U.
// table and act_src must hold rows in [0, N) (the beam reorder builds them
// from in-range parents).

#include "attention_step.cuh"

namespace {

// K3: the step + 1 scores live in shared memory; exact two-pass softmax.
// Shared memory: u + kWarps + groups * d_head floats.
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_step_whole_row(const Args<T> a) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ float smem[];
  const int groups = kThreads / (a.d_head / V);
  float* s = smem;             // [u] scores, then weights
  float* red = s + a.u;        // [kWarps]
  float* part = red + kWarps;  // [groups][d_head]
  const Head<T, false> hd(a, nullptr, blockIdx.x);
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

// K5: K3's whole-row exact softmax over the paged cache, with the
// score pass's lanes mapped to (position, 16-byte vector of d_head) in groups
// of kGroup lanes (nvec rounded up to 8, 16 or 32), so a warp scores 32 /
// kGroup positions at once where K3's scores one with d_head / vec lanes,
// and each thread issues kUnroll positions' loads before using any, in the
// scores and in the values. Each sum is taken in K3's order (a group's
// shuffles are K3's warp_sum less its additions of zeros), so K5 equals K3
// bit for bit. Addressing and the merged-page write are Head<T, true>'s, as
// K6's. Shared memory: u + kWarps + (kThreads / nvec) * d_head floats + u /
// page owners.
template <typename T, int kGroup>
__global__ void __launch_bounds__(kThreads) attn_step_paged_rows(const Args<T> a) {
  constexpr int V = Vec<T>::kN;
  constexpr int kUnroll = 4;
  constexpr int kPerBlock = kWarps * (32 / kGroup);  // positions scored at once
  extern __shared__ float smem[];
  float* s = smem;             // [u] scores, then weights
  float* red = s + a.u;        // [kWarps]
  float* part = red + kWarps;  // [kThreads / nvec][d_head], as K3's
  int* owners = reinterpret_cast<int*>(part + (kThreads / (a.d_head / V)) * a.d_head);
  load_owners<T, true>(a, owners, blockIdx.x);
  const Head<T, true> hd(a, owners, blockIdx.x);
  const int step = a.step;
  const int j = hd.lane % kGroup;  // this thread's vector of d_head
  const bool live = j < hd.nvec;
  float qv[V];
  if (live) load_fresh<T>(a.q + hd.qoff + j * V, qv);

  const int first = hd.warp * (32 / kGroup) + hd.lane / kGroup;
  for (int p0 = 0; p0 <= step; p0 += kPerBlock * kUnroll) {
    uint4 kr[kUnroll];
    float ksc[kUnroll];  // int8: the positions' scales
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + first + u * kPerBlock;
      ok[u] = p <= step && hd.mrow[p];  // masked positions are never read
      if (live && ok[u] && p != step) {
        kr[u] = *reinterpret_cast<const uint4*>(hd.at(p, false) + j * V);
        if constexpr (Vec<T>::kQuant) ksc[u] = hd.ksrow[p];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + first + u * kPerBlock;
      float dot = 0.f;
      if (live && ok[u]) {
        float kx[V];
        if (p == step) {
          load_fresh<T>(a.kh + hd.qoff + j * V, kx);
        } else if constexpr (Vec<T>::kQuant) {
          unpack(kr[u], kx, ksc[u]);
        } else {
          unpack(kr[u], kx);
        }
#pragma unroll
        for (int i = 0; i < V; ++i) dot = fmaf(qv[i], kx[i], dot);
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (j == 0 && p <= step) s[p] = ok[u] ? dot / a.scale : -INFINITY;
    }
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

  // Values in K3's order (groups of nvec threads, group g summing positions
  // g, g + groups, ... in turn), so K5 and K3 give the same bits on the same
  // content, as the paged and physical decodes' comparison needs; only the
  // loads run ahead.
  const int groups = kThreads / hd.nvec;
  const int g = threadIdx.x / hd.nvec;
  const int jv = threadIdx.x % hd.nvec;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (g < groups) {
    for (int p0 = g; p0 <= step; p0 += groups * kUnroll) {
      uint4 vr[kUnroll];
      float vsc[kUnroll];  // int8: the positions' scales
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * groups;
        w[u] = p <= step ? s[p] : 0.f;  // 0 where masked: skipped, never read
        if (w[u] != 0.f && p != step) {
          vr[u] = *reinterpret_cast<const uint4*>(hd.at(p, true) + jv * V);
          if constexpr (Vec<T>::kQuant) vsc[u] = hd.vsrow[p];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * groups;
        if (w[u] != 0.f) {
          float vx[V];
          if (p == step) {
            load_fresh<T>(a.vh + hd.qoff + jv * V, vx);
          } else if constexpr (Vec<T>::kQuant) {
            unpack(vr[u], vx, vsc[u]);
          } else {
            unpack(vr[u], vx);
          }
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(w[u], vx[i], acc[i]);
        }
      }
    }
  }
  finish<V>(acc, sum, part, g, groups, jv, a.d_head, a.out + hd.qoff);
}

template <typename T, int kGroup>
int launch_k5(const Args<T>& a, int nhead, int device, cudaStream_t stream) {
  const int groups = kThreads / (a.d_head / Vec<T>::kN);
  const size_t smem = (static_cast<size_t>(a.u) + kWarps +
                       static_cast<size_t>(groups) * a.d_head) * sizeof(float) +
                      static_cast<size_t>(a.u >> a.page_shift) * sizeof(int);
  static int smem_set[kMaxDevices] = {};
  const int err = allow_smem(attn_step_paged_rows<T, kGroup>, smem, device, smem_set);
  if (err != 0) return err;
  if (a.n > 0) attn_step_paged_rows<T, kGroup><<<a.n * nhead, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K4 / K6: one block per (row, head); see attn_step_chunked_item. At least
// 10 blocks an SM for f32 caches, 8 for bf16 (registers capped at 48 and
// 64): the fastest of the counts tried on an H100 at D2's shapes. int8: 5
// (96 registers), where nvcc's report shows no spill (PERF.md).
template <typename T>
constexpr int kChunkedBlocks = sizeof(T) == 4 ? 10 : (sizeof(T) == 2 ? 8 : 5);

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads, kChunkedBlocks<T>) attn_step_chunked(const Args<T> a) {
  extern __shared__ float smem[];
  attn_step_chunked_item<T, kPaged>(a, blockIdx.x, smem, a.out);
}

// K3 (f32, bf16, int8)
template <typename T>
int launch_k3(const Args<T>& a, int nhead, int device, cudaStream_t stream) {
  const int groups = kThreads / (a.d_head / Vec<T>::kN);
  const size_t smem = (a.u + kWarps + static_cast<size_t>(groups) * a.d_head) * sizeof(float);
  // above 48 KB: U beyond ~11,800 positions
  static int smem_set[kMaxDevices] = {};
  const int err = allow_smem(attn_step_whole_row<T>, smem, device, smem_set);
  if (err != 0) return err;
  if (a.n > 0) attn_step_whole_row<T><<<a.n * nhead, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K4 (kPaged = false) and K6 (kPaged = true), f32, bf16 and int8
template <typename T, bool kPaged>
int launch_streamed(const Args<T>& a, int nhead, int device, cudaStream_t stream) {
  const int groups = kThreads / (a.d_head / Vec<T>::kN);
  const int owners = kPaged ? (a.u >> a.page_shift) : 0;
  const size_t smem = chunked_smem_floats(groups, a.d_head) * sizeof(float) +
                      static_cast<size_t>(owners) * sizeof(int);
  static int smem_set[kMaxDevices] = {};
  const int err = allow_smem(attn_step_chunked<T, kPaged>, smem, device, smem_set);
  if (err != 0) return err;
  if (a.n > 0) attn_step_chunked<T, kPaged><<<a.n * nhead, kThreads, smem, stream>>>(a);
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
                  void* cv, void* ks, void* vs, void* out, int n, int u, int m, int nhead,
                  int step, int layer) {
  Args<T> a = {};
  a.q = static_cast<const float*>(q);
  a.kh = static_cast<const float*>(kh);
  a.vh = static_cast<const float*>(vh);
  a.mask = static_cast<const unsigned char*>(mask);
  a.ks = static_cast<float*>(ks);
  a.vs = static_cast<float*>(vs);
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
                 void* cv, void* ak, void* av, const void* table, const void* act_src, void* ks,
                 void* vs, void* out, int n, int u, int m, int nhead, int step, int layer,
                 int page, int fused, int chunked, int device, cudaStream_t stream) {
  Args<T> a = make_args<T>(q, kh, vh, mask, ck, cv, ks, vs, out, n, u, m, nhead, step, layer);
  a.ak = static_cast<T*>(ak);
  a.av = static_cast<T*>(av);
  a.table = static_cast<const int*>(table);
  a.act_src = static_cast<const int*>(act_src);
  while ((1 << a.page_shift) < page) ++a.page_shift;
  a.row_pos = fused ? 2 * u : u;
  a.page_pos = fused ? 2 * page : page;
  a.slot_pos = fused ? 2 * page : page;
  a.v_off = fused ? page : 0;
  if (chunked) return launch_streamed<T, true>(a, nhead, device, stream);
  const int nvec = a.d_head / Vec<T>::kN;  // lanes per position: nvec rounded up to 8, 16 or 32
  if (nvec <= 8) return launch_k5<T, 8>(a, nhead, device, stream);
  if (nvec <= 16) return launch_k5<T, 16>(a, nhead, device, stream);
  return launch_k5<T, 32>(a, nhead, device, stream);
}

}  // namespace

extern "C" {

// q, kh, vh, out: (n, m) f32; mask: (n, u) bytes, nonzero = valid key;
// ck, cv: (L, n, u, m) caches, f32 (dtype 0), bf16 (dtype 1) or int8 codes
// (dtype 2) with ks, vs their (L, n, u) f32 scales (null
// otherwise); all contiguous on `device`. chunked = 0 launches the
// whole-row kernel (K3), 1 the streamed one (K4). Writes out and the caches'
// (layer, :, step) slices (int8: codes and scales). Launches on `stream` and
// returns cudaGetLastError() (0 on success). Does not synchronise.
int sa_attention_step(const void* q, const void* kh, const void* vh, const void* mask, void* ck,
                      void* cv, void* ks, void* vs, void* out, int n, int u, int m, int nhead,
                      int step, int layer, int dtype, int chunked, int device, void* stream) {
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Args<float> a =
        make_args<float>(q, kh, vh, mask, ck, cv, ks, vs, out, n, u, m, nhead, step, layer);
    return chunked ? launch_streamed<float, false>(a, nhead, device, s)
                   : launch_k3<float>(a, nhead, device, s);
  }
  if (dtype == 1) {
    const Args<__nv_bfloat16> a = make_args<__nv_bfloat16>(q, kh, vh, mask, ck, cv, ks, vs, out,
                                                           n, u, m, nhead, step, layer);
    return chunked ? launch_streamed<__nv_bfloat16, false>(a, nhead, device, s)
                   : launch_k3<__nv_bfloat16>(a, nhead, device, s);
  }
  if (dtype == 2) {
    const Args<int8_t> a =
        make_args<int8_t>(q, kh, vh, mask, ck, cv, ks, vs, out, n, u, m, nhead, step, layer);
    return chunked ? launch_streamed<int8_t, false>(a, nhead, device, s)
                   : launch_k3<int8_t>(a, nhead, device, s);
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
// the page completes). int8 codes (dtype 2, either layout): ks, vs are the
// (L, n, u) f32 scales by own row and logical position, and the launch
// writes each row's fresh scales at (layer, row, step); null otherwise.
// Returns cudaGetLastError(); does not synchronise.
int sa_attention_step_paged(const void* q, const void* kh, const void* vh, const void* mask,
                            void* ck, void* cv, void* ak, void* av, const void* table,
                            const void* act_src, void* ks, void* vs, void* out, int n, int u,
                            int m, int nhead, int step, int layer, int page, int fused, int dtype,
                            int chunked, int device, void* stream) {
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_paged<float>(q, kh, vh, mask, ck, cv, ak, av, table, act_src, ks, vs, out, n, u,
                               m, nhead, step, layer, page, fused, chunked, device, s);
  }
  if (dtype == 1) {
    return launch_paged<__nv_bfloat16>(q, kh, vh, mask, ck, cv, ak, av, table, act_src, ks, vs,
                                       out, n, u, m, nhead, step, layer, page, fused, chunked,
                                       device, s);
  }
  if (dtype == 2) {
    return launch_paged<int8_t>(q, kh, vh, mask, ck, cv, ak, av, table, act_src, ks, vs, out, n,
                                u, m, nhead, step, layer, page, fused, chunked, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

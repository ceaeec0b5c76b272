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
// Here they are `attn_step_whole_row` with physical (kPaged = false: K3) or
// paged addressing (kPaged = true: K5 on int8 caches), `attn_step_chunked`
// instantiated with physical (K4) or paged (K6) addressing, and K5's own
// `attn_step_paged_rows` on f32 and bf16 caches (designs below). Their
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
// kernel's bf16 rounding of q and the dequantized keys: q and the fresh
// kh/vh stay f32 and every sum is f32. The whole-row kernels (K3, K5) read a
// cached element as code * scale in f32 before any product. The chunked
// ones (K4, K6 and K7's attention) factor the scales out of the products, as
// the TPU kernel does on uniform pages (`_subtile_update_unif`,
// ops/pallas/attention_step.py:852-866): s_p = k_scale[p] (q . codes_p) /
// sqrt(d_head), and v_scale[p] folds into the softmax weight before the
// value product; the products run on the tensor cores with q and the scaled
// weights held as three f16 terms (33 significant bits, past f32's 24), so
// they stay within rounding of the f32 math (attn_step_chunked_i8 in
// csrc/attention_step.cuh; ops/attention_step.py `attend_int8_tiled` is its
// plain form). Each launch quantizes the fresh row of
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
// Design: 128 threads per (row, head) work item; d_head = 96 gives N * H =
// 4,224 items at the decode shape, one block each (K4-K6) or walked by as
// many blocks as fit the card at once (K3). A head's slice of one position
// is d_head contiguous elements (384 B in f32), read as 16-byte vectors by
// consecutive lanes. Values: the block splits into groups of d_head / vec
// threads, each group summing every groups-th position, then the groups are
// summed through shared memory. The TPU kernels' devices (the (M, H)
// head-segment matmul, the optimistic fresh-token seed removed at the end,
// per-(row, page) DMA descriptors and the uniform-owner tile flag) exist
// because the TPU cannot index lanes or addresses dynamically; here the
// fresh token's mask bit is read directly and a position's address is
// computed per load, the row's page owners held in shared memory.
//   attn_step_whole_row (K3) keeps the step + 1 scores in shared memory and
//     does an exact softmax. Its first design (a warp scoring one position
//     at a time, one load in flight, every block of a row reading the whole
//     row for the int8 amax) was bound by the chain of dependent load
//     latencies, not by bytes: int8 ran at 13-17% of its bound. Now:
//     - the cached slice moves by TMA, bytes in flight with no thread
//       waiting on them: one 3-D tensor map per cache (32-bit words, dims
//       (M bytes / 4, U, L * N), kept by pointer and shape, so a launch
//       seldom encodes one), one box per `chunk` positions of the item's
//       head (16, 32 or 64 positions: the wrapper's whole_row_layout), into
//       a ring of shared-memory slots completing on mbarriers; k's chunks,
//       then v's, issued by one thread as slots free up, so v arrives while
//       the scores are computed. The last chunk's box ends at step - 1
//       (re-reading positions of the chunk before, or below `chunk` starting
//       before position 0, where TMA delivers zeros), so nothing at or past
//       `step` is copied; masked positions are copied and skipped before any
//       product. The ring stays within the launch's 25-28 KB whatever U is,
//       so eight blocks share an SM;
//     - the blocks are persistent: a block walks items blockIdx.x, +
//       gridDim.x, ..., and its ring runs across them, so the next item's
//       chunks load while this one computes; the items' q, kh and vh head
//       slices come a whole item ahead by bulk copies into a double buffer;
//     - scores and values come from shared memory with K5's lanes: groups
//       of kGroup lanes on (position, 16-byte vector), 2 positions a thread
//       a pass; values in K3's groups;
//     - int8: the row's amax is taken once a row, by its head-0 item, which
//       quantizes every head's fresh k/v and writes the two scales (the
//       other items write nothing at `step`). A thread-block cluster of the
//       row's H blocks exchanging their heads' maxima through distributed
//       shared memory was measured too and lost at every shape (PERF.md).
//       Codes become floats by a byte permute and one subtraction, exactly,
//       where the integer-to-float conversion runs at an eighth of the FMA
//       rate; the dequantization stays code * scale, rounded, before the
//       product.
//     Every sum keeps K3's order, which K5 keeps too, so K3 and K5 give the
//     same bits on the same content (the paged and physical decodes must
//     agree: a K5 that summed in another order flipped D1's near tie): each
//     dot product is a lane's fmaf chain over its vector then the butterfly
//     over the group's lanes (warp_sum less additions of exact zeros), the
//     exp-sum is strided by 128 then block_sum, and values go to group p %
//     groups in increasing p, then finish's order. Staging changes where the
//     bytes come from, not the arithmetic. On the card the redesign is bound
//     by instruction issue and latency in the passes (four FP32 operations
//     an int8 element), not by the copies (PERF.md).
//   attn_step_chunked (K4, K6 on f32 and bf16 caches) streams positions in
//     chunks of 64 with a running max, denominator and accumulator
//     (flash-decoding), so its shared memory does not depend on U. Its body
//     (attn_step_chunked_f, csrc/attention_step.cuh, which K7 runs too)
//     maps the score lanes to (position, 16-byte vector) in groups of 8, 16
//     or 32, keeps 2 positions' loads in flight a thread in both passes,
//     takes two barriers a chunk, and copies the parent's active page to
//     the merged page in the passes that read it, so the page crosses L2
//     once; its sums keep the order of the one-warp-a-position design
//     before it, so K4 and K6 give that design's bits, and each other's.
//   attn_step_chunked_int8 (K4, K6 on int8 caches; K7's attention runs the
//     same body, attn_step_chunked_i8) was that loop with a dequantization
//     per element, at 25% (K4) and 7% (K6) of its bound at D3 on an H100:
//     every block re-read the row's kh and vh for the amax, each element
//     took an integer-to-float conversion, a multiply by its scale and the
//     FMA, and 96 registers a thread held 5 blocks an SM. Now:
//     - the row's head-0 block quantizes every head's fresh k/v and writes
//       the two scales (as K3's head-0 item); no block reads position
//       `step` of the cache or its scale, so none waits for them;
//     - the products are tensor-core mma.sync m16n8k16 on the raw codes,
//       the scales factored out (numerics above): scores are codes (16
//       positions x d) times q's three f16 terms (columns 0-2), values the
//       codes transposed (ldmatrix .trans: d x 16 positions) times the
//       scaled weights' terms; a code becomes an f16 by a byte permute and
//       one f16x2 subtraction, two at a time;
//     - each of the block's 4 warps takes every 4th tile of 16 positions
//       with its own online softmax and stages its tiles (codes and
//       scales, zero-filled where not read) in a ring of its own by
//       cp.async, the next tile's copies in flight while it computes one
//       (2 slots: 30 KB a block and 7 blocks an SM at d_head 96, 22 KB and
//       8 at 64; K7's phase 3 slots); no barrier in the position loop, the
//       warps' partials and the fresh position merged at the end; the
//       row's mask is staged in shared memory once, and a tile's addresses
//       come from its first position's (a tile lies within a page);
//     - paged, each warp copies the parent's active positions of its tiles
//       from its ring to the merged page.
//     K4 and K6 take the same tiles in the same order, so they give the
//     same bits on the same content; K7 int8 runs the body with its
//     shared memory inside K7's 50.2 KB.
//   attn_step_paged_rows (K5 on f32 and bf16 caches) is the whole-row kernel
//     with its position loops rebuilt, because K3's first loops were bound
//     by load latency, not bytes: a warp scored one position with d_head /
//     vec of its lanes loading (12 of 32 for bf16 x 96), a few positions'
//     loads in flight. K5's lanes map to (position, 16-byte vector) in groups
//     of nvec rounded up to 8, 16 or 32, so a warp scores 1-4 positions at
//     once, each group's dot product summed by shuffles within the group;
//     every thread issues the loads of 4 positions before using any, in the
//     scores and in the values. On the card this beat K3's first loops at
//     every paged shape (PERF.md has the measurements), where staging the
//     pages that rows share in shared memory, one block per page with a
//     merge, and whole pages held in registers lost: each cut the blocks
//     resident per SM or lengthened a block's chain of dependent loads.
//   K5 on int8 caches is K3's kernel with paged addresses,
//     attn_step_whole_row<int8_t, 8, true>. Its first build, the loops above
//     with a dequantization per element, ran at 8-16% of its bound on an
//     H100: every block re-read the row's kh and vh for the amax, each
//     element took an integer-to-float conversion and a multiply, 106
//     registers a thread held 4 blocks an SM, and nothing was staged ahead.
//     Now, as K3:
//     - persistent blocks walk the (row, head) items, the cached slices
//       staged by TMA in a shared-memory ring ahead of use, across items, in
//       K3's chunks (whole_row_layout): a chunk comes in boxes of at most a
//       page (two to K3's chunk of 64 at page 32), each from a completed page
//       at its owner row table[n, p / page] (tmk, tmv: K3's maps over the
//       main cache's (M bytes / 4, row_pos, L * N)) or from the parent's read
//       slot, row act_src[n], parity (step + 1) % 2 (tak, tav: the slots as
//       (M bytes / 4, 2 slot_pos, L * N)); no box reaches past the step;
//     - the row's head-0 item quantizes every head's fresh k/v into the
//       merged page and writes the two scales; the other items write nothing
//       at `step`, and no item reads it;
//     - codes become floats by K3's byte permute and subtraction, then code *
//       scale in f32 before the product; every sum in K3's order, so K5 and
//       K3 give the same bits on the same content;
//     - each item copies its share of the merged page before its passes:
//       whole rows (every head's m bytes, whole cache lines) head, head + H,
//       ... of the parent's active positions, global to global. Copying each
//       head's slice out of the ring instead (d_head-byte pieces, by threads
//       or by bulk copies), though the page then crosses L2 once, was slower
//       on an H100.
//     It holds 64 registers (8 blocks an SM). On the card it runs at K3's
//     pace plus the time of the merged page's bytes, which K3 does not move
//     (PERF.md).
// Limits checked by the Python wrappers: d_head a multiple of the vector
// width (4 f32, 8 bf16 or 16 int8 elements) and at most 32 vectors (int8
// K4/K6: 32, 64, 96 or 128), 16-byte aligned
// operands, 0 <= step < U, 0 <= layer < L, a power-of-two page dividing U.
// table and act_src must hold rows in [0, N) (the beam reorder builds them
// from in-range parents).

#include "attention_step.cuh"

namespace {

// K3's shared memory for one launch at `step`: up to kTmaAlign bytes of
// slack to align the ring, then, in bytes from the ring: the ring (`slots`
// slots of `chunk` positions of one head's k or v), its mbarriers and the
// two of the fresh operands, those (two items' q, kh and vh head slices, f32),
// the value groups' partials (groups * d_head floats), the scores of positions 0 ..
// step, int8 the two scale runs of positions 0 .. step - 1, and the
// reduction scratch (kWarps floats). ops/attention_step.py
// `whole_row_layout` computes the same total and hands it to the launch,
// which refuses a mismatch.
constexpr int kTmaAlign = 128;
constexpr int kK3Blocks = 8;  // resident K3 blocks an SM aimed at (64 registers, ~27 KB each)
__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }
struct WholeRowSmem {
  int bars, fresh, part, s, scales, scale_run, red, total;
  __host__ __device__ WholeRowSmem(int step, int d_head, int itemsize, bool quant, int chunk,
                                   int slots) {
    const int row = d_head * itemsize;
    const int groups = kThreads / (row / 16);
    bars = slots * chunk * row;
    fresh = bars + round16(8 * (slots + 2));
    part = fresh + 2 * 3 * d_head * 4;
    s = part + groups * d_head * 4;
    scales = s + round16(4 * (step + 1));
    scale_run = quant ? round16(4 * (step > 0 ? step : 1)) : 0;
    red = scales + 2 * scale_run;
    total = kTmaAlign + red + 4 * kWarps;
  }
};

// int8 K5, by thread 0: the TMA boxes of one chunk of an item's head (k,
// or v with is_v; `row`, the head's first word `x`) from position p0 into
// shared address dst, completing on the mbarrier at `bar`: `box` positions
// a box, each within one page, from a completed page at its owner row
// (tm_main) or from the parent's read slot (tm_slot); none past the step.
template <typename T>
__device__ __forceinline__ void paged_boxes(const Args<T>& a, const CUtensorMap* tm_main,
                                            const CUtensorMap* tm_slot, uint32_t dst, uint32_t bar,
                                            int row, int x, int p0, int chunk, int box,
                                            int row_bytes, bool is_v) {
  const int step = a.step;
  const int act_start = step & ~((1 << a.page_shift) - 1);
  const int vo = is_v ? a.v_off : 0;
  const int boxes = (min(chunk, step - p0) + box - 1) / box;
  mbar_expect(bar, boxes * box * row_bytes);
  for (int b = 0; b < boxes; ++b) {
    const int q = p0 + b * box;
    if (q < act_start) {
      const int pg = q >> a.page_shift;
      const int owner = a.table[static_cast<size_t>(row) * (a.u >> a.page_shift) + pg];
      tma_3d(dst + b * box * row_bytes, tm_main, bar, x,
             pg * a.page_pos + vo + (q - (pg << a.page_shift)), a.layer * a.n + owner);
    } else {
      tma_3d(dst + b * box * row_bytes, tm_slot, bar, x,
             ((step + 1) & 1) * a.slot_pos + vo + (q - act_start), a.layer * a.n + a.act_src[row]);
    }
  }
}

// K3 (kPaged = false) and K5 on int8 caches (kPaged = true): exact
// two-pass softmax over each (row, head) work item, the block's items
// (blockIdx.x, + gridDim.x, ...) in turn, their cached slices staged in one
// shared-memory ring by TMA ahead of use, across items (design in the
// header). kGroup: score lanes a position (nvec rounded up to 8, 16 or 32),
// as K5's. At most 64 registers, so kK3Blocks blocks fit an SM. Paged, the
// chunks come from the owner rows' main pages (tmk, tmv) and the parent's
// read slot (tak, tav) in boxes within one page (paged_boxes), and each item
// copies its share of the merged page, whole rows of the parent's active
// positions; physical, tak and tav are not read.
template <typename T, int kGroup, bool kPaged>
__global__ void __launch_bounds__(kThreads, kK3Blocks)
    attn_step_whole_row(const __grid_constant__ Args<T> a, const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        const __grid_constant__ CUtensorMap tak,
                        const __grid_constant__ CUtensorMap tav, int chunk, int slots) {
  constexpr int V = Vec<T>::kN;
  constexpr bool kQuant = Vec<T>::kQuant;
  constexpr int kPer = kThreads / kGroup;  // positions scored at once by the block
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  unsigned char* const smem =  // the ring, kTmaAlign-aligned
      smem_bytes + ((kTmaAlign - (smem_addr(smem_bytes) & (kTmaAlign - 1))) & (kTmaAlign - 1));
  const int step = a.step;
  const WholeRowSmem lay(step, a.d_head, sizeof(T), kQuant, chunk, slots);
  const uint32_t ring = smem_addr(smem);
  const uint32_t bars = smem_addr(smem + lay.bars);
  const uint32_t fbars = bars + 8 * slots;  // the fresh operands' two mbarriers
  float* fresh = reinterpret_cast<float*>(smem + lay.fresh);  // [2][3][d_head]: q, kh, vh
  float* part = reinterpret_cast<float*>(smem + lay.part);  // [groups][d_head]
  float* s = reinterpret_cast<float*>(smem + lay.s);  // [step + 1] scores, then weights
  float* ksc = reinterpret_cast<float*>(smem + lay.scales);  // int8: [step] scales of k
  float* vsc = reinterpret_cast<float*>(smem + lay.scales + lay.scale_run);  // and of v
  float* red = reinterpret_cast<float*>(smem + lay.red);  // [kWarps]

  const int nhead = a.m / a.d_head;
  const unsigned items = static_cast<unsigned>(a.n) * nhead;
  const int nvec = a.d_head / V;
  const int row_bytes = a.d_head * static_cast<int>(sizeof(T));
  const int slot_bytes = chunk * row_bytes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nc = (step + chunk - 1) / chunk;  // chunks of the cached positions 0 .. step - 1
  const unsigned loads = 2 * nc;              // an item's: k's chunks, then v's
  const unsigned mine = items > blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const unsigned total = mine * loads;        // the block's loads
  // paged: the first position of the active page (the parent's positions
  // act_start .. step - 1 are in its read slot)
  const int act_start = kPaged ? step & ~((1 << a.page_shift) - 1) : step;
  // chunk c holds positions c * chunk .. in a slot whose first position is
  // first_pos(c). Physical, the last chunk's box ends at step - 1 (it
  // re-reads the chunk before, or, below `chunk`, arrives with zeros before
  // position 0). Paged, a chunk is aligned and comes in boxes of `box`
  // positions (the chunk or the page, whichever is shorter), each within one
  // page: a completed page at its owner row, or the parent's read slot;
  // boxes past the step are not issued, and the positions at or past the
  // step in the last one are stale and never used.
  const auto first_pos = [&](int c) { return kPaged ? c * chunk : min(c * chunk, step - chunk); };
  const int box = kPaged ? min(chunk, 1 << a.page_shift) : chunk;

  // The block's load L (item L / loads of its own; of that item k's chunk
  // j, or v's chunk j - nc, j = L % loads) into slot L % slots, issued by
  // thread 0: TMA boxes of the item's head, whatever the mask says (masked
  // bytes never reach a product), nothing of the cache at or past `step`.
  const auto issue = [&](unsigned ld) {
    const unsigned item = blockIdx.x + (ld / loads) * gridDim.x;
    const int j = ld % loads;
    const bool is_v = j >= nc;
    const int p0 = first_pos(is_v ? j - nc : j);
    const int row = item / nhead;  // unsigned division: see Head
    const int x = (item % nhead) * (row_bytes / 4);
    const uint32_t bar = bars + 8 * (ld % slots);
    const uint32_t dst = ring + (ld % slots) * slot_bytes;
    if constexpr (kPaged) {
      paged_boxes(a, is_v ? &tmv : &tmk, is_v ? &tav : &tak, dst, bar, row, x, p0, chunk, box,
                  row_bytes, is_v);
    } else {
      mbar_expect(bar, slot_bytes);
      tma_3d(dst, is_v ? &tmv : &tmk, bar, x, p0, a.layer * a.n + row);
    }
  };
  // The fresh operands of the block's item n (q, kh, vh: its head's d_head
  // floats of each) into buffer n % 2, completing on its mbarrier, by
  // thread 0: one bulk copy each, an item ahead.
  const auto issue_fresh = [&](unsigned n) {
    const unsigned item = blockIdx.x + n * gridDim.x;
    if (item >= items) return;
    const size_t off = static_cast<size_t>(item / nhead) * a.m + (item % nhead) * a.d_head;
    const uint32_t bar = fbars + 8 * (n % 2);
    const uint32_t dst = smem_addr(fresh + (n % 2) * 3 * a.d_head);
    const uint32_t bytes = a.d_head * 4;
    mbar_expect(bar, 3 * bytes);
    bulk_load(dst, a.q + off, bytes, bar);
    bulk_load(dst + bytes, a.kh + off, bytes, bar);
    bulk_load(dst + 2 * bytes, a.vh + off, bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots + 2; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    issue_fresh(0);
    for (unsigned ld = 0; ld < min(static_cast<unsigned>(slots), total); ++ld) issue(ld);
  }
  // Load `ld` has arrived; after the block has used it, its slot takes load
  // ld + slots, perhaps the next item's.
  const auto wait = [&](unsigned ld) { mbar_wait(bars + 8 * (ld % slots), (ld / slots) & 1); };
  const auto release = [&](unsigned ld) {
    __syncthreads();
    if (threadIdx.x == 0 && ld + slots < total) issue(ld + slots);
  };

  const int j = lane % kGroup;  // this thread's vector of d_head in the score pass
  const bool live = j < nvec;
  const int first = threadIdx.x / kGroup;  // its first position in a pass
  const int groups = kThreads / nvec;      // value groups of nvec threads
  const int g = threadIdx.x / nvec;
  const int jv = threadIdx.x % nvec;
  unsigned ld = 0;  // the block's next load
  for (unsigned item = blockIdx.x; item < items; item += gridDim.x) {
    const int row = item / nhead;  // unsigned division: see Head
    const int head = item % nhead;
    const size_t qoff = static_cast<size_t>(row) * a.m + static_cast<size_t>(head) * a.d_head;
    const size_t lrow = static_cast<size_t>(a.layer) * a.n + row;  // (layer, row) of the caches
    const unsigned char* mrow = a.mask + static_cast<size_t>(row) * a.u;
    const unsigned n = (item - blockIdx.x) / gridDim.x;  // the block's item count so far
    __syncthreads();  // the barriers' init; the last item's reads of the scores and scales
    if (threadIdx.x == 0) issue_fresh(n + 1);  // into the buffer the last item used
    const float* fq = fresh + (n % 2) * 3 * a.d_head;  // this item's q, kh, vh
    const float* fk = fq + a.d_head;
    const float* fv = fk + a.d_head;

    // Where this item's head of position `step` goes (no item reads it):
    // physical, the row's own position; paged, position step - act_start of
    // the merged page: main page step / page of the row when the step
    // completes it, else the row's parity slot step % 2.
    const auto dst_at = [&](bool is_v) -> T* {
      const size_t hoff = static_cast<size_t>(head) * a.d_head;
      if constexpr (kPaged) {
        const int page = 1 << a.page_shift;
        const bool to_main = step - act_start == page - 1;
        const size_t at =
            (to_main ? lrow * a.row_pos + static_cast<size_t>(step >> a.page_shift) * a.page_pos
                     : (lrow * 2 + (step & 1)) * a.slot_pos) +
            (step - act_start) + (is_v ? a.v_off : 0);
        return (to_main ? (is_v ? a.cv : a.ck) : (is_v ? a.av : a.ak)) + at * a.m + hoff;
      } else {
        return (is_v ? a.cv : a.ck) + (lrow * a.u + step) * a.m + hoff;
      }
    };
    // While the copies fly: the scales, the fresh k/v's writeback (paged:
    // and the merged page's copy), q and the fresh position's score.
    if constexpr (kQuant) {
      const float* ks = a.ks + lrow * a.u;
      const float* vs = a.vs + lrow * a.u;
      for (int p = threadIdx.x; p < step; p += kThreads) {
        ksc[p] = ks[p];
        vsc[p] = vs[p];
      }
      if (head == 0) {  // the row's quantizer, once a row (by its head-0 item)
        quantize_fresh_row(a.kh + static_cast<size_t>(row) * a.m,
                           a.vh + static_cast<size_t>(row) * a.m, dst_at(false), dst_at(true),
                           a.ks + lrow * a.u + step, a.vs + lrow * a.u + step, a.m, red);
      }
    }
    if constexpr (kPaged) {
      // this item's share of the merged page: the parent's positions
      // act_start .. step - 1 as whole rows of every head (m contiguous
      // elements, whole cache lines), rows head, head + nhead, ... of k, then
      // of v, from the parent's read slot, as bytes, masked ones too
      const int o = step - act_start;
      const int row_vecs = a.m * static_cast<int>(sizeof(T)) / 16;
      const int rows = o > head ? (o - head - 1) / nhead + 1 : 0;
      const size_t slot =  // the parent's read slot, in rows of m
          ((static_cast<size_t>(a.layer) * a.n + (rows > 0 ? a.act_src[row] : 0)) * 2 +
           ((step + 1) & 1)) * a.slot_pos;
      const size_t back = static_cast<size_t>(o) * a.m + static_cast<size_t>(head) * a.d_head;
      const auto bytes = [](const T* p) { return reinterpret_cast<const unsigned char*>(p); };
      const unsigned char* ksrc = bytes(a.ak + slot * a.m);
      const unsigned char* vsrc = bytes(a.av + (slot + a.v_off) * a.m);
      unsigned char* kdst = reinterpret_cast<unsigned char*>(dst_at(false) - back);
      unsigned char* vdst = reinterpret_cast<unsigned char*>(dst_at(true) - back);
      for (int x = threadIdx.x; x < 2 * rows * row_vecs; x += kThreads) {
        const bool is_v = x >= rows * row_vecs;
        const int y = is_v ? x - rows * row_vecs : x;
        const size_t off = static_cast<size_t>(head + nhead * (y / row_vecs)) * a.m * sizeof(T) +
                           (y % row_vecs) * 16;
        *reinterpret_cast<uint4*>((is_v ? vdst : kdst) + off) =
            *reinterpret_cast<const uint4*>((is_v ? vsrc : ksrc) + off);
      }
    }
    const bool fresh_ok = mrow[step] != 0;
    mbar_wait(fbars + 8 * (n % 2), (n / 2) & 1);
    if constexpr (!kQuant) {
      if (warp < 2 && lane < nvec) {
        float x[V];
        load_fresh<T>((warp == 0 ? fk : fv) + lane * V, x);
        store_vec(dst_at(warp == 1) + lane * V, x);
      }
    }
    float qv[V];
    if (live) load_fresh<T>(fq + j * V, qv);
    if (warp == 0) {  // the fresh position, by warp 0's first group
      const bool ok = fresh_ok;
      float dot = 0.f;
      if (lane < kGroup && live && ok) {
        float kx[V];
        load_fresh<T>(fk + j * V, kx);
#pragma unroll
        for (int i = 0; i < V; ++i) dot = fmaf(qv[i], kx[i], dot);
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) s[step] = ok ? dot / a.scale : -INFINITY;
    }
    __syncthreads();  // the staged scales

    // Scores, a chunk at a time from its slot: lanes on (position, vector)
    // in groups of kGroup, two positions a thread before the shuffles; each
    // dot product in K3's order (see the header).
    for (int c = 0; c < nc; ++c, ++ld) {
      wait(ld);
      const int p0 = c * chunk;
      const int cnt = min(chunk, step - p0);
      const unsigned char* buf =
          smem + (ld % slots) * slot_bytes + (p0 - first_pos(c)) * row_bytes + j * 16;
      for (int i0 = 0; i0 < cnt; i0 += 2 * kPer) {
        uint4 kr[2];
        bool ok[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + first + u * kPer;
          ok[u] = i < cnt && mrow[p0 + i];  // masked positions never reach a product
          if (live && ok[u]) kr[u] = *reinterpret_cast<const uint4*>(buf + i * row_bytes);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + first + u * kPer;
          float dot = 0.f;
          if (live && ok[u]) {
            float x[V];
            if constexpr (kQuant) {
              unpack_codes(kr[u], x, ksc[p0 + i]);
            } else {
              unpack(kr[u], x);
            }
#pragma unroll
            for (int e = 0; e < V; ++e) dot = fmaf(qv[e], x[e], dot);
          }
#pragma unroll
          for (int off = kGroup / 2; off > 0; off >>= 1) {
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          }
          if (j == 0 && i < cnt) s[p0 + i] = ok[u] ? dot / a.scale : -INFINITY;
        }
      }
      release(ld);
    }
    __syncthreads();  // every score

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

    // Values in K3's order: group g of nvec threads sums positions g, g +
    // groups, ... in turn, across the chunks, the fresh position last.
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    int p = g;  // this group's next position
    for (int c = 0; c < nc; ++c, ++ld) {
      wait(ld);
      const int p0 = first_pos(c);
      const unsigned char* buf = smem + (ld % slots) * slot_bytes + jv * 16;
      const int end = min(step, (c + 1) * chunk);
      if (g < groups) {
        for (; p < end; p += 2 * groups) {
          const int p1 = p + groups;
          const float w0 = s[p];
          const float w1 = p1 < end ? s[p1] : 0.f;
          uint4 r0, r1;
          if (w0 != 0.f) r0 = *reinterpret_cast<const uint4*>(buf + (p - p0) * row_bytes);
          if (w1 != 0.f) r1 = *reinterpret_cast<const uint4*>(buf + (p1 - p0) * row_bytes);
          if (w0 != 0.f) {
            float x[V];
            if constexpr (kQuant) {
              unpack_codes(r0, x, vsc[p]);
            } else {
              unpack(r0, x);
            }
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = fmaf(w0, x[i], acc[i]);
          }
          if (w1 != 0.f) {
            float x[V];
            if constexpr (kQuant) {
              unpack_codes(r1, x, vsc[p1]);
            } else {
              unpack(r1, x);
            }
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = fmaf(w1, x[i], acc[i]);
          }
        }
        if (p - groups >= end) p -= groups;  // the pair's second position lay past this chunk
      }
      release(ld);
    }
    if (g < groups && p == step && s[step] != 0.f) {
      float x[V];
      load_fresh<T>(fv + jv * V, x);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(s[step], x[i], acc[i]);
    }
    finish<V>(acc, sum, part, g, groups, jv, a.d_head, a.out + qoff);
  }
}

// K5 on f32 and bf16 caches: K3's whole-row exact softmax over the paged cache, with the
// score pass's lanes mapped to (position, 16-byte vector of d_head) in groups
// of kGroup lanes (nvec rounded up to 8, 16 or 32), so a warp scores 32 /
// kGroup positions at once where K3's scores one with d_head / vec lanes,
// and each thread issues kUnroll positions' loads before using any, in the
// scores and in the values. Each sum is taken in K3's order (a group's
// shuffles are K3's warp_sum less its additions of zeros), so K5 equals K3
// bit for bit. Addressing and the merged-page write are Head<T, true>'s, as
// K6's. Shared memory: u + kWarps + (kThreads / nvec) * d_head floats + u /
// page owners. int8 caches take attn_step_whole_row<int8_t, 8, true>.
template <typename T, int kGroup>
__global__ void __launch_bounds__(kThreads) attn_step_paged_rows(const Args<T> a) {
  static_assert(!Vec<T>::kQuant, "int8 K5 is attn_step_whole_row<int8_t, kGroup, true>");
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
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + first + u * kPerBlock;
      ok[u] = p <= step && hd.mrow[p];  // masked positions are never read
      if (live && ok[u] && p != step) {
        kr[u] = *reinterpret_cast<const uint4*>(hd.at(p, false) + j * V);
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
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * groups;
        w[u] = p <= step ? s[p] : 0.f;  // 0 where masked: skipped, never read
        if (w[u] != 0.f && p != step) {
          vr[u] = *reinterpret_cast<const uint4*>(hd.at(p, true) + jv * V);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * groups;
        if (w[u] != 0.f) {
          float vx[V];
          if (p == step) {
            load_fresh<T>(a.vh + hd.qoff + jv * V, vx);
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

// K4 / K6 on f32 and bf16 caches: one block per (row, head); see
// attn_step_chunked_f. At least 10 blocks an SM for f32 caches, 8 for bf16
// (registers capped at 48 and 64): the fastest of the counts tried on an
// H100 at D2's shapes.
template <typename T>
constexpr int kChunkedBlocks = sizeof(T) == 4 ? 10 : 8;

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads, kChunkedBlocks<T>) attn_step_chunked(const Args<T> a) {
  extern __shared__ float smem[];
  attn_step_chunked_item<T, kPaged>(a, blockIdx.x, smem, a.out);
}

// K4 / K6 on int8 caches: one block per (row, head); see attn_step_chunked_i8.
// Each warp has kI8Stages ring slots (30 KB of shared memory a block at
// d_head 96, 22 KB at 64), and an SM holds at least i8_blocks(d_head / 16)
// blocks (registers capped at 65536 / (128 x blocks)): the fastest of 4-8
// blocks with 2 or 3 slots on an H100 at D3 (PERF.md); at 128, shared
// memory allows 5.
constexpr int kI8Stages = 2;
__host__ __device__ constexpr int i8_blocks(int dtiles) {
  return dtiles <= 4 ? 8 : (dtiles <= 6 ? 7 : 5);
}

template <bool kPaged, int kDT>
__global__ void __launch_bounds__(kThreads, i8_blocks(kDT))
    attn_step_chunked_int8(const Args<int8_t> a) {
  extern __shared__ __align__(16) unsigned char smem_i8[];
  attn_step_chunked_i8<kPaged, kDT, kI8Stages>(a, blockIdx.x, smem_i8, a.out);
}

template <bool kPaged, int kDT>
int launch_i8_as(const Args<int8_t>& a, int nhead, int device, cudaStream_t stream) {
  const auto kernel = attn_step_chunked_int8<kPaged, kDT>;
  const size_t smem =
      chunked_i8_smem(16 * kDT, kI8Stages, a.u, kPaged ? (a.u >> a.page_shift) : 0);
  static int smem_set[kMaxDevices] = {};
  const int err = allow_smem(kernel, smem, device, smem_set);
  if (err != 0) return err;
  if (a.n > 0) kernel<<<a.n * nhead, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K3's TMA map of one (layers, n, u, m) cache as 32-bit words (any element
// type: the boxes are copied as bytes): dims (m * itemsize / 4, u, layers *
// n), boxes of one head (row_bytes / 4 words) x `chunk` positions x one row.
// A decode's caches are few and long-lived, so maps are kept by pointer and
// shape and a launch seldom encodes one. Returns 0 or a CUDA error.
int k3_map(CUtensorMap* map, const void* ptr, int layers, int n, int u, int m_bytes,
           int row_bytes, int chunk) {
  struct Key {
    const void* ptr;
    int layers, n, u, m_bytes, row_bytes, chunk;
  };
  constexpr int kKept = 32;
  static Key keys[kKept];
  static CUtensorMap maps[kKept];
  static int kept = 0, next = 0;
  const Key key = {ptr, layers, n, u, m_bytes, row_bytes, chunk};
  for (int i = 0; i < kept; ++i) {
    const Key& k = keys[i];
    if (k.ptr == ptr && k.layers == layers && k.n == n && k.u == u && k.m_bytes == m_bytes &&
        k.row_bytes == row_bytes && k.chunk == chunk) {
      *map = maps[i];
      return 0;
    }
  }
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(m_bytes / 4), static_cast<cuuint64_t>(u),
                              static_cast<cuuint64_t>(layers) * n};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(m_bytes),
                                 static_cast<cuuint64_t>(u) * m_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(row_bytes / 4),
                             static_cast<cuuint32_t>(chunk), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&maps[next], CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(ptr), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  keys[next] = key;
  *map = maps[next];
  next = (next + 1) % kKept;
  kept = kept < kKept ? kept + 1 : kKept;
  return 0;
}

// K3 (f32, bf16, int8) and K5 on int8 caches (kPaged) with the wrapper's
// ring (chunk, slots) and shared memory `smem`, which must be
// WholeRowSmem's: as many blocks as fit the card at once (the occupancy of
// the last `smem` seen is kept), each walking its share of the N * H items.
template <typename T, int kGroup, bool kPaged>
int launch_whole_row_as(const Args<T>& a, const CUtensorMap (&maps)[4], int nhead, int chunk,
                        int slots, int smem, int device, cudaStream_t stream) {
  const auto kernel = attn_step_whole_row<T, kGroup, kPaged>;
  static int smem_set[kMaxDevices] = {};
  int err = allow_smem(kernel, smem, device, smem_set);
  if (err != 0) return err;
  static int sms[kMaxDevices] = {};
  static int fit_smem[kMaxDevices] = {};
  static int fit[kMaxDevices] = {};
  if (sms[device] == 0) {
    err = static_cast<int>(cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                                  device));
    if (err != 0) return err;
  }
  if (fit_smem[device] != smem) {
    err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[device], kernel, kThreads, smem));
    if (err != 0) return err;
    if (fit[device] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    fit_smem[device] = smem;
  }
  const long items = static_cast<long>(a.n) * nhead;
  const int grid = static_cast<int>(items < static_cast<long>(sms[device]) * fit[device]
                                        ? items
                                        : static_cast<long>(sms[device]) * fit[device]);
  if (grid == 0) return 0;
  kernel<<<grid, kThreads, smem, stream>>>(a, maps[0], maps[1], maps[2], maps[3], chunk, slots);
  return static_cast<int>(cudaGetLastError());
}

// The maps of K3's caches (k, v; the last two unused) or of K5's paged
// cache (main k and v: (L, N, row_pos, M); the parity slots of k and v:
// (L, N, 2 slot_pos, M), for each layout; fused, k's map is v's), then the
// launch. Paged, a chunk must lie within one page.
template <typename T, bool kPaged>
int launch_whole_row(const Args<T>& a, int layers, int nhead, int chunk, int slots, int smem,
                     int device, cudaStream_t stream) {
  if (chunk <= 0 || slots < (a.step > 0) || device < 0 || device >= kMaxDevices ||
      (kPaged && chunk % min(chunk, 1 << a.page_shift) != 0) ||
      WholeRowSmem(a.step, a.d_head, sizeof(T), Vec<T>::kQuant, chunk, slots).total != smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m_bytes = a.m * static_cast<int>(sizeof(T));
  const int row_bytes = a.d_head * static_cast<int>(sizeof(T));
  CUtensorMap maps[4];
  const int rows = kPaged ? a.row_pos : a.u;
  const int box = kPaged ? min(chunk, 1 << a.page_shift) : chunk;  // positions a TMA box
  int err = k3_map(&maps[0], a.ck, layers, a.n, rows, m_bytes, row_bytes, box);
  if (err == 0) err = k3_map(&maps[1], a.cv, layers, a.n, rows, m_bytes, row_bytes, box);
  if (kPaged) {
    if (err == 0) err = k3_map(&maps[2], a.ak, layers, a.n, 2 * a.slot_pos, m_bytes, row_bytes, box);
    if (err == 0) err = k3_map(&maps[3], a.av, layers, a.n, 2 * a.slot_pos, m_bytes, row_bytes, box);
  } else {
    maps[2] = maps[0];
    maps[3] = maps[1];
  }
  if (err != 0) return err;
  const int nvec = a.d_head / Vec<T>::kN;  // score lanes a position: nvec rounded up to 8, 16 or 32
  if (nvec <= 8) {
    return launch_whole_row_as<T, 8, kPaged>(a, maps, nhead, chunk, slots, smem, device, stream);
  }
  if (nvec <= 16) {
    return launch_whole_row_as<T, 16, kPaged>(a, maps, nhead, chunk, slots, smem, device, stream);
  }
  return launch_whole_row_as<T, 32, kPaged>(a, maps, nhead, chunk, slots, smem, device, stream);
}

// K4 (kPaged = false) and K6 (kPaged = true), f32, bf16 and int8 (d_head
// 32, 64, 96 or 128)
template <typename T, bool kPaged>
int launch_streamed(const Args<T>& a, int nhead, int device, cudaStream_t stream) {
  if constexpr (Vec<T>::kQuant) {
    switch (a.d_head) {
      case 32: return launch_i8_as<kPaged, 2>(a, nhead, device, stream);
      case 64: return launch_i8_as<kPaged, 4>(a, nhead, device, stream);
      case 96: return launch_i8_as<kPaged, 6>(a, nhead, device, stream);
      case 128: return launch_i8_as<kPaged, 8>(a, nhead, device, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
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
                 void* vs, void* out, int layers, int n, int u, int m, int nhead, int step,
                 int layer, int page, int fused, int chunked, int chunk, int slots, int smem,
                 int device, cudaStream_t stream) {
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
  if (chunked) {
    // int8: a tile of kI8Tile positions lies within one page
    if (Vec<T>::kQuant && page < kI8Tile) return static_cast<int>(cudaErrorInvalidValue);
    return launch_streamed<T, true>(a, nhead, device, stream);
  }
  if constexpr (Vec<T>::kQuant) {
    return launch_whole_row<T, true>(a, layers, nhead, chunk, slots, smem, device, stream);
  } else {
    const int nvec = a.d_head / Vec<T>::kN;  // lanes per position: nvec rounded up to 8, 16 or 32
    if (nvec <= 8) return launch_k5<T, 8>(a, nhead, device, stream);
    if (nvec <= 16) return launch_k5<T, 16>(a, nhead, device, stream);
    return launch_k5<T, 32>(a, nhead, device, stream);
  }
}

}  // namespace

extern "C" {

// q, kh, vh, out: (n, m) f32; mask: (n, u) bytes, nonzero = valid key;
// ck, cv: (layers, n, u, m) caches, f32 (dtype 0), bf16 (dtype 1) or int8 codes
// (dtype 2) with ks, vs their (L, n, u) f32 scales (null
// otherwise); all contiguous on `device`. chunked = 0 launches the
// whole-row kernel (K3) with its ring of `slots` slots of `chunk` positions
// and `smem` bytes of shared memory (ops/attention_step.py
// `whole_row_layout`; refused unless they agree); chunked = 1 the streamed
// one (K4), which ignores those three. Writes out
// and the caches' (layer, :, step) slices (int8: codes and scales).
// Launches on `stream` and returns cudaGetLastError() (0 on success). Does
// not synchronise.
int sa_attention_step(const void* q, const void* kh, const void* vh, const void* mask, void* ck,
                      void* cv, void* ks, void* vs, void* out, int layers, int n, int u, int m,
                      int nhead, int step, int layer, int dtype, int chunked, int chunk, int slots,
                      int smem, int device, void* stream) {
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Args<float> a =
        make_args<float>(q, kh, vh, mask, ck, cv, ks, vs, out, n, u, m, nhead, step, layer);
    return chunked ? launch_streamed<float, false>(a, nhead, device, s)
                   : launch_whole_row<float, false>(a, layers, nhead, chunk, slots, smem, device, s);
  }
  if (dtype == 1) {
    const Args<__nv_bfloat16> a = make_args<__nv_bfloat16>(q, kh, vh, mask, ck, cv, ks, vs, out,
                                                           n, u, m, nhead, step, layer);
    return chunked ? launch_streamed<__nv_bfloat16, false>(a, nhead, device, s)
                   : launch_whole_row<__nv_bfloat16, false>(a, layers, nhead, chunk, slots, smem, device, s);
  }
  if (dtype == 2) {
    const Args<int8_t> a =
        make_args<int8_t>(q, kh, vh, mask, ck, cv, ks, vs, out, n, u, m, nhead, step, layer);
    return chunked ? launch_streamed<int8_t, false>(a, nhead, device, s)
                   : launch_whole_row<int8_t, false>(a, layers, nhead, chunk, slots, smem, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The paged kernels, K5 (chunked = 0) and K6 (chunked = 1). q, kh, vh, out,
// mask as above; u is the logical cache length and page (a power of two)
// divides it. Split layout (fused = 0): ck, cv (layers, n, u, m) and ak, av
// (layers, n, 2, page, m). Fused layout (fused = 1): ck = cv the (layers, n,
// 2u, m) cache and ak = av the (layers, n, 2, 2 page, m) slots. table: (n, u
// / page) int32; act_src: (n,) int32. Writes out and this layer's merged
// active page of every row (its parity slot step % 2, or its main page step
// / page when the page completes). int8 codes (dtype 2, either layout): ks,
// vs are the (L, n, u) f32 scales by own row and logical position, and the
// launch writes each row's fresh scales at (layer, row, step); null
// otherwise. int8 K5 is the whole-row kernel with its ring of `slots` slots
// of `chunk` positions (dividing the page) and `smem` bytes of shared memory
// (ops/attention_step.py `whole_row_layout`; refused unless they agree);
// the other launches ignore those three. Returns cudaGetLastError(); does
// not synchronise.
int sa_attention_step_paged(const void* q, const void* kh, const void* vh, const void* mask,
                            void* ck, void* cv, void* ak, void* av, const void* table,
                            const void* act_src, void* ks, void* vs, void* out, int layers, int n,
                            int u, int m, int nhead, int step, int layer, int page, int fused,
                            int dtype, int chunked, int chunk, int slots, int smem, int device,
                            void* stream) {
  const int err = use_device(device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_paged<float>(q, kh, vh, mask, ck, cv, ak, av, table, act_src, ks, vs, out,
                               layers, n, u, m, nhead, step, layer, page, fused, chunked, chunk,
                               slots, smem, device, s);
  }
  if (dtype == 1) {
    return launch_paged<__nv_bfloat16>(q, kh, vh, mask, ck, cv, ak, av, table, act_src, ks, vs,
                                       out, layers, n, u, m, nhead, step, layer, page, fused,
                                       chunked, chunk, slots, smem, device, s);
  }
  if (dtype == 2) {
    return launch_paged<int8_t>(q, kh, vh, mask, ck, cv, ak, av, table, act_src, ks, vs, out,
                                layers, n, u, m, nhead, step, layer, page, fused, chunked, chunk,
                                slots, smem, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

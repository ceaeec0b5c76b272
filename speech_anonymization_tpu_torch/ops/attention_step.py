"""K3 and K4: one decoder layer's single-token attention against the stacked cache.

Counterpart of the non-paged part of
``speech_anonymization_tpu/ops/pallas/attention_step.py``:
``cached_attention_step`` -> ``_attn_step_call`` -> ``_kernel`` (K3, whole
row) or ``_kernel_chunked`` (K4, U streamed). The CUDA kernels are the two
``__global__`` functions of ``csrc/attention_step.cu``; its header states the
numerics, the bound and the design. :func:`attention_step` launches K3 and
:func:`attention_step_chunked` K4 for CUDA tensors; both use
:func:`attention_step_plain` only for tensors on the CPU.
:func:`cached_attention_step` picks between them by the JAX rule, so the same
shape takes the same kernel on both sides.

Contract, for layer ``layer`` of an (L, N, U, M) cache and host int ``step``:
q/kh/vh (N, M) f32 heads (flat), mask (N, U) nonzero = valid key. Returns the
(N, M) f32 attention output over positions <= step (position ``step`` taking
the fresh kh/vh) and writes kh/vh into the cache at ``(layer, :, step)`` in
place. f32 caches compute in f32; bf16 caches round q/kh/vh to bf16 and
accumulate in f32.

int8 caches (the JAX package's ``decode_cache_dtype: int8``; K3 and K4, and
K5-K7 on the paged caches) are the reference math of
``MultiHeadAttention.attend_cached`` and ``finalize_jnp``:

* the caches hold int8 codes; ``k_scale``/``v_scale`` (L, N, U) f32 hold one
  symmetric scale per (layer, row, position), indexed by the row's own
  logical position in both cache layouts;
* the fresh row of M values (all heads) is quantized once, by
  :func:`quantize_rows`: ``amax = max(max|x|, 1e-6)``, ``code =
  clip(round(x * (127 / amax)), -127, 127)`` rounding half to even, ``scale
  = amax / 127``, each division in IEEE f32. The TPU kernel's ``amax * (1 /
  127)`` can differ in the last bit, and so does ``finalize_jnp`` under
  ``jax.jit``, where XLA rewrites the division by the constant 127 as that
  product; the contract is the division;
* q and the fresh kh/vh stay f32 (the fresh token is not quantized in the
  step that writes it), and every sum is f32. K3 and K5 (and the plain
  twins) read a cached element as ``code * scale`` in f32 before any
  product. K4, K6 and K7 factor the scales out, as the TPU kernel does on
  uniform pages (``_subtile_update_unif``, ``attention_step.py:852-866``):
  ``s_p = k_scale[p] * (q . codes_p) / sqrt(d)``, and ``v_scale[p]`` folds
  into the softmax weight before the value product; they take the products
  on the tensor cores, q and the scaled weights held as three f16 terms
  (33 significant bits, past f32's 24), within 1e-5 of the twins.
  :func:`attend_int8_tiled` is that arithmetic in plain PyTorch. The TPU
  kernel rounds q and the dequantized keys to bf16 for its matrix unit; the
  port does not copy that, as its f32 contract does not;
* scales at positions > step, or masked, may be stale or NaN: they are
  replaced before any product, like the codes they belong to.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

# The TPU kernel's VMEM budget for its k+v scratch tiles
# (``attention_step.py:1103``). It sets where the whole-row kernel hands over
# to the chunked one; the port keeps the rule so both sides pick the same
# kernel, though on the card the boundary is still to be re-tuned.
_VMEM_BUDGET = 10 * 2**20
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_VECS = 32  # 16-byte vectors of one head: one warp lane each
# Head widths the int8 chunked body (K4, K6 and K7's attention on int8 caches:
# ``attn_step_chunked_i8``, d_head / 16 tensor-core tiles, an even count) takes.
I8_CHUNKED_HEADS = (32, 64, 96, 128)
# K3 (``attn_step_whole_row``; int8 K5 is its paged build) stages each (row,
# head)'s cached k and v in a ring of shared-memory slots of `chunk`
# positions: the longest of
# K3_CHUNKS (64 only from step 64 on) with room for two slots in K3_SMEM
# beside the rest of its shared memory, and as many slots as fit there (none
# past the launch's loads: none at step 0). K3_SMEM lets eight blocks share an
# H100 SM (228 KB, less the 1 KB the runtime keeps a block).
K3_CHUNKS = (64, 32, 16)
K3_SMEM = 233_472 // 8 - 1024
_THREADS, _WARPS = 128, 4  # a K3 block


def _round16(x: int) -> int:
    return (x + 15) & ~15


@functools.lru_cache(maxsize=None)
def whole_row_layout(step: int, d_head: int, itemsize: int) -> tuple[int, int, int]:
    """(chunk, slots, shared-memory bytes) of K3's (and int8 K5's) launch at ``step``: 128
    bytes of slack to align the ring for TMA, its slots, their mbarriers and
    the fresh operands' two, those (two items' q, kh and vh head slices), the
    value groups' partials, the step + 1 scores, int8 the two scale runs of
    positions before the step, and the reduction scratch;
    ``csrc/attention_step.cu`` ``WholeRowSmem`` lays out the same bytes and
    refuses other totals."""
    row = d_head * itemsize
    part = (_THREADS // (row // 16)) * d_head * 4
    scales = 2 * _round16(4 * max(step, 1)) if itemsize == 1 else 0
    rest = 128 + 2 * 3 * d_head * 4 + part + _round16(4 * (step + 1)) + scales + 4 * _WARPS
    for chunk in K3_CHUNKS:
        if chunk > max(step, K3_CHUNKS[1]):  # 64 only from step 64 on
            continue
        loads = 2 * -(-step // chunk)  # k's chunks, then v's
        # round16(8 (slots + 2)) <= 8 slots + 24
        slots = min(loads, (K3_SMEM - rest - 24) // (chunk * row + 8))
        if slots >= min(loads, 2):
            break
    slots = max(slots, min(loads, 1))
    return chunk, slots, rest + slots * chunk * row + _round16(8 * (slots + 2))


def max_u_whole_row(m: int, itemsize: int) -> int:
    """Largest U the TPU's whole-row kernel held in VMEM at its minimum row tile."""
    return _VMEM_BUDGET // (2 * 8 * m * itemsize)


def uses_chunked(u: int, m: int, dtype: torch.dtype) -> bool:
    """The JAX dispatch rule (``_attn_step_call``): U beyond the whole-row bound."""
    return u > max_u_whole_row(m, max(dtype.itemsize, 2))


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., M) f32 rows -> ((..., M) int8 codes, (...,) f32 scales): the
    int8 contract's quantizer (module docstring), ``finalize_jnp``'s form."""
    amax = x.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    # tensor by tensor: ``127.0 / amax`` is a reciprocal times 127, and on
    # CUDA ``amax / 127.0`` a product by 1 / 127; neither is the IEEE division
    c127 = torch.full_like(amax, 127.0)
    codes = torch.clamp(torch.round(x * torch.div(c127, amax)), -127, 127).to(torch.int8)
    return codes, torch.div(amax, c127)[..., 0]


def attend_plain(q: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, mask: torch.Tensor,
                 k_buf: torch.Tensor, v_buf: torch.Tensor, step: int, nhead: int,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' attention math in plain PyTorch (the same numerics by dtype).

    k_buf/v_buf: (N, step + 1, M) in the cache's dtype, one layer's content of
    positions <= step; position ``step`` is ignored (the fresh kh/vh take it).
    int8: k_scale/v_scale (N, step + 1) f32, each position's scale. Writes
    nothing.
    """
    n, m = q.shape
    d = m // nhead
    fresh = (q, kh, vh)
    if k_buf.dtype == torch.bfloat16:
        fresh = tuple(x.to(torch.bfloat16).float() for x in fresh)
    qf, khf, vhf = (x.reshape(n, 1, nhead, d) for x in fresh)
    p = step + 1
    pos = torch.arange(p, device=q.device).view(1, p, 1, 1)
    valid = (mask[:, :p] != 0).view(n, p, 1, 1)
    # stale or masked positions are replaced BEFORE any product: 0 * NaN is NaN
    kb = k_buf.float()
    vb = v_buf.float()
    if k_buf.dtype == torch.int8:  # dequantized element by element, as the kernels do
        kb = kb * k_scale[:, :, None]
        vb = vb * v_scale[:, :, None]
    kb = kb.view(n, p, nhead, d)
    vb = vb.view(n, p, nhead, d)
    kb = torch.where(valid, torch.where(pos == step, khf, kb), 0.0)
    vb = torch.where(valid, torch.where(pos == step, vhf, vb), 0.0)
    scores = torch.einsum("nqhd,nphd->nhp", qf, kb) / math.sqrt(d)
    scores = torch.where(valid.view(n, 1, p), scores, -1e30)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("nhp,nphd->nhd", weights, vb).reshape(n, m)


I8_TILE, I8_WARPS = 16, 4  # attn_step_chunked_i8's positions a tile, warps a block


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf: a * b + c rounded once to f32 (through f64, where a * b is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as f32, e an int tensor in [-126, 127], exactly."""
    return ((e.int() + 127) << 23).view(torch.float32)


def _f16_shift(amax: torch.Tensor) -> torch.Tensor:
    """The power-of-two shift that puts amax (>= 0) in [2^13, 2^14); 0 for 0,
    clamped to +-100 (the kernel's ``f16_shift``)."""
    e = ((amax.view(torch.int32) >> 23) & 0xFF) - 126
    return torch.where(amax > 0, (14 - e).clamp(-100, 100), torch.zeros_like(e))


def _f16_terms(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x = t0 + t1 + t2 + rest, each term an f16 value (as f32): t0 = f16(x),
    t1 = f16(x - t0), t2 = f16(x - t0 - t1)."""
    t0 = x.half().float()
    r1 = x - t0
    t1 = r1.half().float()
    return t0, t1, (r1 - t1).half().float()


def _mma_sum(codes: torch.Tensor, terms: torch.Tensor, dim: int) -> torch.Tensor:
    """One tensor-core k-step: the exact sum of code x term products over
    ``dim``, rounded once to f32."""
    return (codes.double() * terms.double()).sum(dim).float()


def attend_int8_tiled(q: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, mask: torch.Tensor,
                      k_buf: torch.Tensor, v_buf: torch.Tensor, step: int, nhead: int,
                      k_scale: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """The int8 chunked kernels' arithmetic (``csrc/attention_step.cuh``
    ``attn_step_chunked_i8``: K4, K6 and K7's attention on int8 caches) in
    plain PyTorch, with :func:`attend_plain`'s arguments: the scales factored
    out of the products (score = k_scale[p] (q . codes_p) / sqrt(d), v_scale[p]
    folded into the weight), q and the weights split into three f16 terms
    after a power-of-two shift (per (row, head) for q, per tile for the
    weights), tiles of 16 positions taken by 4 warps in turn (warp w: tiles
    w, w + 4, ...), each warp's online softmax, then the warps' partials and
    the fresh position (f32 q . kh, weight times vh) merged in that order.
    Each tensor-core k-step is an exact sum rounded once to f32; the kernel's
    own rounding inside a product can differ in the last bits."""
    n, m = q.shape
    d = m // nhead
    f32 = torch.float32
    qh, khh, vhh = (x.view(n, nhead, d) for x in (q, kh, vh))
    scale = torch.tensor(float(d), dtype=f32, device=q.device).sqrt()
    neg_inf = torch.tensor(-math.inf, dtype=f32, device=q.device)
    zero = torch.zeros((), dtype=f32, device=q.device)
    # q's terms and the fresh position's q . kh: four quarters (d = 16 t + 4
    # tq + i, fmaf chains over t, i), then (p0 + p1) + (p2 + p3)
    qsh = _f16_shift(qh.abs().amax(-1))
    qterms = _f16_terms(qh * _pow2(qsh)[..., None])
    quarters = [torch.zeros(n, nhead, dtype=f32, device=q.device) for _ in range(4)]
    for t in range(d // 16):
        for tq in range(4):
            for i in range(4):
                e = 16 * t + 4 * tq + i
                quarters[tq] = _fma(qh[..., e], khh[..., e], quarters[tq])
    fdot = (quarters[0] + quarters[1]) + (quarters[2] + quarters[3])
    s_fresh = torch.where(mask[:, step:step + 1] != 0, fdot / scale, neg_inf)

    ntiles = -(-step // I8_TILE)
    pad = ntiles * I8_TILE
    valid = torch.zeros(n, pad, dtype=torch.bool, device=q.device)
    valid[:, :step] = mask[:, :step] != 0

    def padded(x, fill):  # positions 0 .. step - 1 padded to whole tiles
        out = x.new_full((n, pad, *x.shape[2:]), fill)
        out[:, :step] = x[:, :step]
        return out

    kc = padded(k_buf, 0).view(n, pad, nhead, d).float()
    vc = padded(v_buf, 0).view(n, pad, nhead, d).float()
    ks = torch.where(valid, padded(k_scale, 0.0), zero)  # zero-filled where not read
    vs = torch.where(valid, padded(v_scale, 0.0), zero)
    parts = []
    for w in range(I8_WARPS):
        m_run = torch.full((n, nhead), -math.inf, dtype=f32, device=q.device)
        l_run = torch.zeros(n, nhead, dtype=f32, device=q.device)
        acc = [torch.zeros(n, nhead, d, dtype=f32, device=q.device) for _ in range(3)]
        for j in range(w, ntiles, I8_WARPS):
            sl = slice(I8_TILE * j, I8_TILE * (j + 1))
            codes = kc[:, sl].permute(0, 2, 1, 3)  # (n, H, 16, d)
            cols = []
            for term in qterms:  # column i: k-step by k-step
                c = torch.zeros(n, nhead, I8_TILE, dtype=f32, device=q.device)
                for t in range(d // 16):
                    ds = slice(16 * t, 16 * (t + 1))
                    c = (c.double() + (codes[..., ds].double() * term[:, :, None, ds].double())
                         .sum(-1)).float()
                cols.append(c)
            dot = ((cols[2] + cols[1]) + cols[0]) * _pow2(-qsh)[..., None]
            s = torch.where(valid[:, None, sl], dot * ks[:, None, sl] / scale, neg_inf)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.where(m_run == -math.inf, zero, torch.exp(m_run - m_new))
            wt = torch.where(s == -math.inf, zero, torch.exp(s - m_new[..., None]))
            u = wt[..., :8] + wt[..., 8:]  # lane g: positions g and g + 8, then the butterfly
            u = u[..., :4] + u[..., 4:]
            u = u[..., :2] + u[..., 2:]
            l_run = _fma(l_run, alpha, u[..., 0] + u[..., 1])
            m_run = m_new
            va = wt * vs[:, None, sl]
            vsh = _f16_shift(va.amax(-1))
            vterms = _f16_terms(va * _pow2(vsh)[..., None])
            vcodes = vc[:, sl].permute(0, 2, 1, 3)  # (n, H, 16, d)
            down = _pow2(-vsh)[..., None]
            acc = [a * alpha[..., None] + _mma_sum(vcodes, term[..., None], 2) * down
                   for a, term in zip(acc, vterms)]
        parts.append((m_run, l_run, (acc[2] + acc[1]) + acc[0]))
    mx = s_fresh
    for m_w, _, _ in parts:
        mx = torch.maximum(mx, m_w)
    num = torch.zeros(n, nhead, d, dtype=f32, device=q.device)
    den = torch.zeros(n, nhead, dtype=f32, device=q.device)
    for m_w, l_w, part in parts:
        f = torch.where(m_w == -math.inf, zero, torch.exp(m_w - mx))
        num = _fma(f[..., None], part, num)
        den = _fma(f, l_w, den)
    ff = torch.where(s_fresh == -math.inf, zero, torch.exp(s_fresh - mx))
    num = _fma(ff[..., None], vhh, num)
    den = den + ff
    out = torch.where(den[..., None] > 0, num / den[..., None], zero)
    return out.reshape(n, m)


def attention_step_plain(q: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, mask: torch.Tensor,
                         cache_k: torch.Tensor, cache_v: torch.Tensor, step: int, layer: int,
                         nhead: int, k_scale: torch.Tensor | None = None,
                         v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' function in plain PyTorch (the same numerics by dtype).
    int8 caches take their (L, N, U) ``k_scale``/``v_scale``, written at
    ``(layer, :, step)`` beside the codes."""
    p = step + 1
    scales = (None, None)
    if cache_k.dtype == torch.int8:
        scales = (k_scale[layer, :, :p], v_scale[layer, :, :p])
    out = attend_plain(q, kh, vh, mask, cache_k[layer, :, :p], cache_v[layer, :, :p], step, nhead,
                       *scales)
    for cache, scale, fresh in ((cache_k, k_scale, kh), (cache_v, v_scale, vh)):
        if cache.dtype == torch.int8:
            cache[layer, :, step], scale[layer, :, step] = quantize_rows(fresh)
        else:
            cache[layer, :, step] = fresh.to(cache.dtype)
    return out


def check_step_operands(q, kh, vh, mask, tensors: dict, itemsize: int, layers: int, n: int,
                        u: int, m: int, step: int, layer: int, nhead: int) -> None:
    """Raises on what K3-K6 do not take, apart from the cache layout: the
    fresh (N, M) f32 operands, the (N, U) mask, one device, contiguity,
    16-byte alignment of every operand but the mask and the int tables, the
    head width, step and layer.
    ``tensors``: the named cache operands; the first one's device is the
    kernels'."""
    for name, x in (("q", q), ("kh", kh), ("vh", vh)):
        if x.dtype != torch.float32 or x.shape != (n, m):
            raise ValueError(f"{name} must be ({n}, {m}) float32, got {tuple(x.shape)} {x.dtype}")
    if mask.shape != (n, u) or mask.dtype not in (torch.bool, torch.int8, torch.uint8):
        raise ValueError(f"mask must be ({n}, {u}) bool/int8/uint8, got {tuple(mask.shape)} "
                         f"{mask.dtype}")
    device = next(iter(tensors.values())).device
    for name, x in {"q": q, "kh": kh, "vh": vh, "mask": mask, **tensors}.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the cache on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name not in ("mask", "table", "act_src") and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    vec = 16 // itemsize
    if nhead <= 0 or m % nhead:
        raise ValueError(f"d_model {m} is not a multiple of {nhead} heads")
    d = m // nhead
    if d % vec or d // vec > _MAX_VECS:
        raise ValueError(f"head width {d} unsupported for {itemsize}-byte cache elements")
    if not 0 <= step < u:
        raise ValueError(f"step {step} outside the cache's {u} positions")
    if not 0 <= layer < layers:
        raise ValueError(f"layer {layer} outside the cache's {layers} layers")


def check_scales(k_scale, v_scale, layers: int, n: int, u: int) -> dict:
    """Raises unless both int8 scale arrays are given as (L, N, U) f32;
    returns them by name for :func:`check_step_operands`."""
    if k_scale is None or v_scale is None:
        raise TypeError("int8 caches need their k_scale and v_scale")
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        if x.dtype != torch.float32 or x.shape != (layers, n, u):
            raise ValueError(f"{name} must be ({layers}, {n}, {u}) float32, got {tuple(x.shape)} "
                             f"{x.dtype}")
    return {"k_scale": k_scale, "v_scale": v_scale}


def _check(q, kh, vh, mask, cache_k, cache_v, step, layer, nhead, k_scale, v_scale) -> None:
    if cache_k.dtype not in _DTYPE_CODES or cache_v.dtype != cache_k.dtype:
        raise TypeError(f"attention_step takes float32, bfloat16 or int8 caches, got "
                        f"{cache_k.dtype}/{cache_v.dtype}")
    if cache_k.ndim != 4 or cache_v.shape != cache_k.shape:
        raise ValueError(f"caches must be (L, N, U, M) of one shape, got {tuple(cache_k.shape)} "
                         f"and {tuple(cache_v.shape)}")
    layers, n, u, m = cache_k.shape
    scales = check_scales(k_scale, v_scale, layers, n, u) if cache_k.dtype == torch.int8 else {}
    check_step_operands(q, kh, vh, mask, {"cache_k": cache_k, "cache_v": cache_v, **scales},
                        cache_k.element_size(), layers, n, u, m, step, layer, nhead)


_fn = None  # the bound C entry point, set on first launch


def check_int8_chunked_head(d_head: int) -> None:
    """Raises unless the int8 chunked body takes heads of width ``d_head``."""
    if d_head not in I8_CHUNKED_HEADS:
        raise ValueError(f"the int8 chunked kernels take head widths {I8_CHUNKED_HEADS}, "
                         f"not {d_head}")


def _entry():
    """``sa_attention_step`` with its argument types, bound once."""
    global _fn
    if _fn is None:
        from ..utils import cuda_build

        fn = cuda_build.load("attention_step").sa_attention_step
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(chunked: bool, q, kh, vh, mask, cache_k, cache_v, step, layer, nhead, k_scale,
            v_scale) -> torch.Tensor:
    _check(q, kh, vh, mask, cache_k, cache_v, step, layer, nhead, k_scale, v_scale)
    layers, n, u, m = cache_k.shape
    if chunked and cache_k.dtype == torch.int8:
        check_int8_chunked_head(m // nhead)
    out = torch.empty(n, m, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ks, vs = (0, 0) if k_scale is None else (k_scale.data_ptr(), v_scale.data_ptr())
    ring = (0, 0, 0) if chunked else whole_row_layout(step, m // nhead, cache_k.element_size())
    err = _entry()(q.data_ptr(), kh.data_ptr(), vh.data_ptr(), mask.data_ptr(), cache_k.data_ptr(),
                   cache_v.data_ptr(), ks, vs, out.data_ptr(), layers, n, u, m, nhead, step, layer,
                   _DTYPE_CODES[cache_k.dtype], int(chunked), *ring, q.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"attention_step kernel launch failed: CUDA error {err}")
    return out


def _dispatch(wrapper, chunked: bool, q, kh, vh, mask, cache_k, cache_v, step, layer, nhead,
              k_scale, v_scale) -> torch.Tensor:
    args = (q, kh, vh, mask, cache_k, cache_v, step, layer, nhead, k_scale, v_scale)
    device = cache_k.device
    if device.type == "cpu":
        return attention_step_plain(*args)
    if device.type != "cuda":
        raise ValueError(f"attention_step runs on cuda or cpu, not {device}")
    out = _launch(chunked, *args)
    wrapper.launches += 1
    return out


def attention_step(q, kh, vh, mask, cache_k, cache_v, step: int, layer: int, nhead: int,
                   k_scale=None, v_scale=None) -> torch.Tensor:
    """K3, the whole-row kernel (counts one in ``attention_step.launches``);
    int8 caches take their (L, N, U) scales, written at ``(layer, :, step)``."""
    return _dispatch(attention_step, False, q, kh, vh, mask, cache_k, cache_v, step, layer, nhead,
                     k_scale, v_scale)


def attention_step_chunked(q, kh, vh, mask, cache_k, cache_v, step: int, layer: int, nhead: int,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """K4, the streamed kernel (counts one in ``attention_step_chunked.launches``);
    int8 caches take their (L, N, U) scales, written at ``(layer, :, step)``."""
    return _dispatch(attention_step_chunked, True, q, kh, vh, mask, cache_k, cache_v, step, layer,
                     nhead, k_scale, v_scale)


attention_step.launches = 0
attention_step_chunked.launches = 0


def cached_attention_step(q, kh, vh, mask, cache_k, cache_v, step: int, layer: int, nhead: int,
                          k_scale=None, v_scale=None) -> torch.Tensor:
    """K3 or K4 by the JAX rule: chunked when U > ``max_u_whole_row(M, max(itemsize, 2))``."""
    _, _, u, m = cache_k.shape
    kernel = attention_step_chunked if uses_chunked(u, m, cache_k.dtype) else attention_step
    return kernel(q, kh, vh, mask, cache_k, cache_v, step, layer, nhead, k_scale, v_scale)

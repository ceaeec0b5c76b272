"""K5 and K6: one decoder layer's single-token attention over a PAGED cache.

Counterpart of the paged part of
``speech_anonymization_tpu/ops/pallas/attention_step.py``:
``cached_attention_step_paged`` -> ``_attn_step_paged_call`` ->
``_kernel_paged`` (K5, whole row, page 32) or ``_kernel_chunked_paged`` (K6,
U streamed, page 64), and ``cached_attention_step_paged_fused`` ->
``_attn_step_paged_fused_call`` -> ``_kernel_chunked_paged`` (K6 on the
fused-KV layout). The CUDA kernels are in ``csrc/attention_step.cu``: K6 is
K4's ``__global__`` function instantiated with paged addressing; K5 on f32
and bf16 caches its own (``attn_step_paged_rows``, K3's whole-row softmax
with lanes mapped to positions), on int8 caches K3's kernel with paged
addressing (``attn_step_whole_row<int8_t, 8, true>``: the TMA ring, the
persistent blocks and the layout of :func:`whole_row_layout`, which the
launch hands over as K3's does); its header states the numerics, the bound
and the designs.

The paged cache is the lazy beam reorder (``models.transformer``): k/v never
move between rows. Completed page ``p`` of row ``n`` lives in the main cache
at row ``table[n, p]``; the ACTIVE page (the one holding ``step``) was
written at step - 1 by row ``act_src[n]`` (this row's beam parent) into its
parity slot ``(step + 1) % 2``. Each launch attends over that logical row,
then writes the MERGED active page (the parent's positions
``(step // page) * page .. step - 1``, then the fresh k/v at ``step``) to
its OWN row: to slot ``step % 2``, or to main page ``step // page`` when
``step % page == page - 1`` completes the page. Positions of the destination
beyond ``step`` are not written. Blocks read only slot ``(step + 1) % 2`` and
pages below ``step // page``, and write only the other slot or that page, so
the in-place writes cannot race.

Layouts (``make_kv_cache(paged=True)``), as a dict:
  split: ``k``/``v`` (L, N, U, M), ``k_act``/``v_act`` (L, N, 2, page, M);
  fused: ``kv`` (L, N, 2U, M), each logical page stored as [K-page, V-page],
         and ``kv_act`` (L, N, 2, 2 * page, M);
  both:  ``table`` (N, U / page) int32, ``act_src`` (N,) int32.
  int8:  ``k_scale``/``v_scale`` (L, N, U) f32 beside the int8 codes (either
         layout: K5 at page 32, K6 at page 64, split or fused).
q/kh/vh are (N, M) f32, mask (N, U) nonzero = valid key. f32 caches compute
in f32; bf16 caches round q/kh/vh to bf16 and accumulate in f32; int8 caches
follow ``ops/attention_step.py``'s int8 contract. The scales, like the mask,
are indexed by the row's OWN logical position: paging moves only the code
bytes, the beam reorder gathers the scales along N, and each launch writes
the fresh row's scales at (layer, own row, step).
:func:`attention_step_paged` launches K5 and :func:`attention_step_paged_chunked`
K6 for CUDA tensors (either layout); both use the plain twins only for
tensors on the CPU.
:func:`cached_attention_step_paged` picks between them by the JAX rule.
"""

from __future__ import annotations

import ctypes

import torch

from .attention_step import (
    _DTYPE_CODES,
    I8_TILE,
    attend_plain,
    check_int8_chunked_head,
    check_scales,
    check_step_operands,
    quantize_rows,
    uses_chunked,
    whole_row_layout,
)

# Page sizes (``attention_step.py:403,407``): whole-row caches page by 32
# positions, chunked (long) caches by 64, the chunked kernel's grain.
PAGE = 32
PAGE_LONG = 64


def max_u_for_kernel(m: int, itemsize: int) -> int:
    """Largest U that some paged kernel serves (``attention_step.py:1119``):
    the chunked kernel streams U, so this is no practical cap."""
    return 16384


def page_views(cache: dict):
    """(k_pages, v_pages, k_act, v_act) views of either layout:
    (L, N, U/page, page, M) main pages and (L, N, 2, page, M) parity slots."""
    up = cache["table"].shape[1]
    if "kv" in cache:
        kv, act = cache["kv"], cache["kv_act"]
        layers, n, u2, m = kv.shape
        page = u2 // 2 // up
        pages = kv.view(layers, n, up, 2, page, m)
        return pages[:, :, :, 0], pages[:, :, :, 1], act[:, :, :, :page], act[:, :, :, page:]
    k, v = cache["k"], cache["v"]
    layers, n, u, m = k.shape
    page = u // up
    return (k.view(layers, n, up, page, m), v.view(layers, n, up, page, m), cache["k_act"],
            cache["v_act"])


def _paged_plain(q, kh, vh, mask, cache: dict, step: int, layer: int, nhead: int) -> torch.Tensor:
    k_pages, v_pages, k_act, v_act = page_views(cache)
    _, n, up, page, m = k_pages.shape
    p_act, o = divmod(step, page)
    par_w, par_r = step % 2, (step + 1) % 2
    owners = cache["table"][:, :p_act].long()
    parent = cache["act_src"].long()
    cols = torch.arange(p_act, device=owners.device)

    def logical(pages, act):
        # positions < step: completed pages through the table, then the
        # parent's slot; position `step` is a placeholder for the fresh token
        done = pages[layer][owners, cols].reshape(n, p_act * page, m)
        active = act[layer, parent, par_r, :o]
        return torch.cat([done, active, active.new_zeros(n, 1, m)], dim=1), active

    k_buf, k_parent = logical(k_pages, k_act)
    v_buf, v_parent = logical(v_pages, v_act)
    quant = k_buf.dtype == torch.int8
    scales = ((cache["k_scale"][layer, :, :step + 1], cache["v_scale"][layer, :, :step + 1])
              if quant else ())
    out = attend_plain(q, kh, vh, mask, k_buf, v_buf, step, nhead, *scales)
    completes = o == page - 1
    for key, pages, act, parent_page, fresh in (("k_scale", k_pages, k_act, k_parent, kh),
                                                ("v_scale", v_pages, v_act, v_parent, vh)):
        dst = pages[layer, :, p_act] if completes else act[layer, :, par_w]
        dst[:, :o] = parent_page  # the parent's codes, as bytes
        if quant:  # the fresh code at o, its scale at (layer, own row, step)
            dst[:, o], cache[key][layer, :, step] = quantize_rows(fresh)
        else:
            dst[:, o] = fresh.to(dst.dtype)
    return out


def attention_step_paged_plain(q, kh, vh, mask, cache: dict, step: int, layer: int,
                               nhead: int) -> torch.Tensor:
    """The split-layout kernels' function in plain PyTorch (``k``, ``v``,
    ``k_act``, ``v_act``, ``table``, ``act_src``); writes the merged page."""
    if "kv" in cache:
        raise ValueError("attention_step_paged_plain takes the split layout; see "
                         "attention_step_paged_fused_plain")
    return _paged_plain(q, kh, vh, mask, cache, step, layer, nhead)


def attention_step_paged_fused_plain(q, kh, vh, mask, cache: dict, step: int, layer: int,
                                     nhead: int) -> torch.Tensor:
    """The fused-layout kernel's function in plain PyTorch (``kv``, ``kv_act``,
    ``table``, ``act_src``); writes the merged page."""
    if "kv" not in cache:
        raise ValueError("attention_step_paged_fused_plain takes the fused layout; see "
                         "attention_step_paged_plain")
    return _paged_plain(q, kh, vh, mask, cache, step, layer, nhead)


def _operands(cache: dict):
    """(main_k, main_v, act_k, act_v, fused) of either layout; fused passes
    one tensor for k and v."""
    if "kv" in cache:
        return cache["kv"], cache["kv"], cache["kv_act"], cache["kv_act"], True
    return cache["k"], cache["v"], cache["k_act"], cache["v_act"], False


def _check(q, kh, vh, mask, cache, step, layer, nhead) -> tuple[int, int, bool]:
    """Raises on what the kernels do not take; returns (U, page, fused)."""
    main_k, main_v, act_k, act_v, fused = _operands(cache)
    table, act_src = cache["table"], cache["act_src"]
    if main_k.dtype not in _DTYPE_CODES or {main_v.dtype, act_k.dtype, act_v.dtype} != {main_k.dtype}:
        raise TypeError(f"paged attention takes float32, bfloat16 or int8 caches, got "
                        f"{main_k.dtype}/{main_v.dtype}/{act_k.dtype}/{act_v.dtype}")
    if main_k.ndim != 4 or main_v.shape != main_k.shape:
        raise ValueError(f"main caches must be (L, N, U, M) of one shape, got "
                         f"{tuple(main_k.shape)} and {tuple(main_v.shape)}")
    layers, n, rows, m = main_k.shape
    u = rows // 2 if fused else rows
    if table.dtype != torch.int32 or table.ndim != 2 or table.shape[0] != n or table.shape[1] == 0:
        raise ValueError(f"table must be ({n}, U / page) int32, got {tuple(table.shape)} {table.dtype}")
    up = table.shape[1]
    page = u // up
    if page * up != u or page & (page - 1):
        raise ValueError(f"U {u} is not a power-of-two page size times the table's {up} columns")
    slot = (layers, n, 2, 2 * page if fused else page, m)
    if act_k.shape != slot or act_v.shape != slot:
        raise ValueError(f"active-page slots must be {slot}, got {tuple(act_k.shape)}")
    if act_src.dtype != torch.int32 or act_src.shape != (n,):
        raise ValueError(f"act_src must be ({n},) int32, got {tuple(act_src.shape)} {act_src.dtype}")
    scales = {}
    if main_k.dtype == torch.int8:
        scales = check_scales(cache.get("k_scale"), cache.get("v_scale"), layers, n, u)
    check_step_operands(q, kh, vh, mask, {"main cache": main_k, "main v cache": main_v,
                                          "active slots": act_k, "active v slots": act_v,
                                          "table": table, "act_src": act_src, **scales},
                        main_k.element_size(), layers, n, u, m, step, layer, nhead)
    return u, page, fused


_fn = None  # the bound C entry point, set on first launch


def _entry():
    """``sa_attention_step_paged`` with its argument types, bound once."""
    global _fn
    if _fn is None:
        from ..utils import cuda_build

        fn = cuda_build.load("attention_step").sa_attention_step_paged
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(chunked: bool, q, kh, vh, mask, cache, step, layer, nhead) -> torch.Tensor:
    u, page, fused = _check(q, kh, vh, mask, cache, step, layer, nhead)
    main_k, main_v, act_k, act_v, _ = _operands(cache)
    n, m = q.shape
    if chunked and main_k.dtype == torch.int8:
        check_int8_chunked_head(m // nhead)
        if page < I8_TILE:
            raise ValueError(f"the int8 chunked kernel takes pages of {I8_TILE} positions or "
                             f"more, not {page}")
    # int8 K5's ring (chunk, slots, shared memory) is K3's; the other launches take none
    int8_k5 = main_k.dtype == torch.int8 and not chunked
    ring = whole_row_layout(step, m // nhead, 1) if int8_k5 else (0, 0, 0)
    out = torch.empty(n, m, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ks, vs = ((cache["k_scale"].data_ptr(), cache["v_scale"].data_ptr())
              if main_k.dtype == torch.int8 else (0, 0))
    err = _entry()(q.data_ptr(), kh.data_ptr(), vh.data_ptr(), mask.data_ptr(), main_k.data_ptr(),
                   main_v.data_ptr(), act_k.data_ptr(), act_v.data_ptr(),
                   cache["table"].data_ptr(), cache["act_src"].data_ptr(), ks, vs,
                   out.data_ptr(), main_k.shape[0], n, u, m, nhead, step, layer, page, int(fused),
                   _DTYPE_CODES[main_k.dtype], int(chunked), *ring, q.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"paged attention_step kernel launch failed: CUDA error {err}")
    return out


def _dispatch(wrapper, chunked: bool, q, kh, vh, mask, cache, step, layer, nhead) -> torch.Tensor:
    device = cache["table"].device
    if device.type == "cpu":
        return _paged_plain(q, kh, vh, mask, cache, step, layer, nhead)
    if device.type != "cuda":
        raise ValueError(f"paged attention_step runs on cuda or cpu, not {device}")
    out = _launch(chunked, q, kh, vh, mask, cache, step, layer, nhead)
    wrapper.launches += 1
    return out


def attention_step_paged(q, kh, vh, mask, cache: dict, step: int, layer: int,
                         nhead: int) -> torch.Tensor:
    """K5, the whole-row kernel over a paged cache (counts one in
    ``attention_step_paged.launches``)."""
    return _dispatch(attention_step_paged, False, q, kh, vh, mask, cache, step, layer, nhead)


def attention_step_paged_chunked(q, kh, vh, mask, cache: dict, step: int, layer: int,
                                 nhead: int) -> torch.Tensor:
    """K6, the streamed kernel over a paged cache, split or fused (counts one
    in ``attention_step_paged_chunked.launches``); int8 caches carry their
    scales in the dict, as for K5."""
    return _dispatch(attention_step_paged_chunked, True, q, kh, vh, mask, cache, step, layer, nhead)


attention_step_paged.launches = 0
attention_step_paged_chunked.launches = 0


def cached_attention_step_paged(q, kh, vh, mask, cache: dict, step: int, layer: int,
                                nhead: int) -> torch.Tensor:
    """K5 or K6 by the JAX rule: the fused layout and U beyond
    ``max_u_whole_row(M, max(itemsize, 2))`` take the chunked kernel."""
    main_k = cache["kv"] if "kv" in cache else cache["k"]
    chunked = "kv" in cache or uses_chunked(mask.shape[1], main_k.shape[-1], main_k.dtype)
    kernel = attention_step_paged_chunked if chunked else attention_step_paged
    return kernel(q, kh, vh, mask, cache, step, layer, nhead)

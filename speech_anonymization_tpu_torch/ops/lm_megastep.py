"""K7: every layer of one TransformerLM decode step in one kernel launch.

Counterpart of ``speech_anonymization_tpu/ops/pallas/lm_megastep.py``:
``prepare_lm_megastep`` (the weights stacked once) and ``lm_megastep`` ->
``_lm_megastep_call`` -> ``_kernel_mega``. The CUDA kernel is
``csrc/lm_megastep.cu``; its header states the function, the numerics, the
bound and the design. In short, per layer: q/k/v projections, K6's attention
over the fused-KV paged cache (writing the merged active page in place), the
out-projection, residual + LayerNorm, the feed-forward, residual +
LayerNorm, with bf16 weights and activations rounded to bf16 before each
product, f32 accumulation and f32 residuals. int8 caches
(``ops/attention_step.py``'s contract) take their (L, N, U) ``k_scale``/
``v_scale``: each layer quantizes its fresh k/v on writeback and writes their
scales at ``(layer, :, step)`` in place; its attention is K4/K6's int8 body,
scales factored out of the products (heads of 32, 64, 96 or 128 on the
card).

:func:`lm_megastep` launches the kernel for CUDA tensors (one cooperative
launch, counted in ``lm_megastep.launches``; the exact-GELU build's, the
``sb_compat`` LM's, also in ``lm_megastep.exact_launches``) and runs
:func:`lm_megastep_plain`, which follows the kernel's rounding points, only
for tensors on the CPU. Both refuse what the kernel does not take: int8
codes without their scales, the split layout, a page other than 64, a
``d_model`` that is not a multiple of 128, a ``d_ffn`` that is not a multiple
of ``d_model``, misaligned or non-contiguous operands.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .attention_step import (_DTYPE_CODES, check_int8_chunked_head, check_scales,
                             check_step_operands)
from .attention_step_paged import PAGE_LONG, _paged_plain

LN_EPS = 1e-6  # flax nn.LayerNorm default, inside the rsqrt
# d_model must be a multiple: the kernel's 64-wide product tiles, and the
# out-projection's two K-slices in the products' stages of up to 64
_M_ALIGN = 128


def _nb(nf: int) -> int:
    """Weight blocks per layer: q, k, v, o and nf (w1, w2) pairs."""
    return 4 + 2 * nf


@torch.no_grad()
def prepare_lm_megastep(mats, rows) -> tuple[torch.Tensor, torch.Tensor]:
    """Lay out an LM's layer weights in the kernel's block order, once per model.

    ``mats[l]`` holds layer l's (Wq, Wk, Wv, Wo, W1, W2) in the (in, out)
    layout (W1 (M, F), W2 (F, M)); ``rows[l]`` its (bq, bk, bv, bo, b1 (F,),
    b2, ln1 scale, ln1 bias, ln2 scale, ln2 bias). Returns ``(wall, vecs)``:
    ``wall (L * NB, M, M)`` bf16 weight blocks in stream order [q, k, v, o,
    w1_c0, w2_c0, ...] (NB = 4 + 2 nf, nf = F / M) and ``vecs (L, 9 + nf, M)``
    f32 rows [bq, bk, bv, bo, b1 (nf rows), b2, ln1 scale, ln1 bias, ln2
    scale, ln2 bias]: bit for bit what the JAX function returns for the same
    weights.
    """
    m, f = mats[0][4].shape
    if f % m:
        raise ValueError(f"the LM step kernel needs d_ffn ({f}) a multiple of d_model ({m})")
    nf = f // m
    blocks, vecs = [], []
    for (wq, wk, wv, wo, w1, w2), (bq, bk, bv, bo, b1, *rest) in zip(mats, rows):
        lb = [wq, wk, wv, wo]
        for c in range(nf):
            lb += [w1[:, c * m:(c + 1) * m], w2[c * m:(c + 1) * m]]
        blocks.append(torch.stack([b.to(torch.bfloat16) for b in lb]))
        vecs.append(torch.stack([r.float() for r in (bq, bk, bv, bo, *b1.view(nf, m), *rest)]))
    return torch.cat(blocks).contiguous(), torch.stack(vecs).contiguous()


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax's LayerNorm as the kernel computes it: fast variance, eps inside."""
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _check(x0, mask, cache_kv, act_kv, table, act_src, step, wall, vecs, nhead, k_scale,
           v_scale) -> tuple[int, int]:
    """Raises on what the kernel does not take; returns (layers, d_ffn)."""
    if cache_kv.dtype not in _DTYPE_CODES or act_kv.dtype != cache_kv.dtype:
        raise TypeError(f"the LM step kernel takes float32, bfloat16 or int8 caches, got "
                        f"{cache_kv.dtype}/{act_kv.dtype}")
    if cache_kv.ndim != 4 or act_kv.ndim != 5:
        raise ValueError(f"the LM step kernel takes the fused layout: kv (L, N, 2U, M) and kv_act "
                         f"(L, N, 2, 2 * page, M), got {tuple(cache_kv.shape)} and "
                         f"{tuple(act_kv.shape)}")
    layers, n, rows, m = cache_kv.shape
    u = rows // 2
    if table.dtype != torch.int32 or table.ndim != 2 or table.shape[0] != n or table.shape[1] == 0:
        raise ValueError(f"table must be ({n}, U / page) int32, got {tuple(table.shape)} {table.dtype}")
    page = u // table.shape[1]
    if page != PAGE_LONG or page * table.shape[1] != u:
        raise ValueError(f"the LM step kernel takes page {PAGE_LONG}; U {u} over "
                         f"{table.shape[1]} table columns is not")
    if act_kv.shape != (layers, n, 2, 2 * page, m):
        raise ValueError(f"kv_act must be the fused layout's {(layers, n, 2, 2 * page, m)}, got "
                         f"{tuple(act_kv.shape)} (the split layout is not taken)")
    if act_src.dtype != torch.int32 or act_src.shape != (n,):
        raise ValueError(f"act_src must be ({n},) int32, got {tuple(act_src.shape)} {act_src.dtype}")
    if m % _M_ALIGN:
        raise ValueError(f"d_model {m} is not a multiple of {_M_ALIGN}")
    nb = wall.shape[0] // layers if wall.ndim == 3 else 0
    if (wall.dtype != torch.bfloat16 or wall.ndim != 3 or wall.shape != (layers * nb, m, m)
            or nb < _nb(1) or nb % 2):
        raise ValueError(f"wall must be ({layers} * (4 + 2 nf), {m}, {m}) bfloat16, got "
                         f"{tuple(wall.shape)} {wall.dtype}")
    nf = (nb - 4) // 2
    if vecs.dtype != torch.float32 or vecs.shape != (layers, 9 + nf, m):
        raise ValueError(f"vecs must be ({layers}, {9 + nf}, {m}) float32, got "
                         f"{tuple(vecs.shape)} {vecs.dtype}")
    scales = (check_scales(k_scale, v_scale, layers, n, u) if cache_kv.dtype == torch.int8
              else {})
    # x0 stands for q/kh/vh: the fresh operands are (N, M) f32 like it
    check_step_operands(x0, x0, x0, mask, {"kv cache": cache_kv, "kv slots": act_kv,
                                           "table": table, "act_src": act_src, "wall": wall,
                                           "vecs": vecs, **scales},
                        cache_kv.element_size(), layers, n, u, m, step, 0, nhead)
    return layers, nf * m


def lm_megastep_plain(x0, mask, cache_kv, act_kv, table, act_src, step: int, wall, vecs,
                      nhead: int, exact_gelu: bool = False, k_scale=None, v_scale=None):
    """The kernel's function in plain PyTorch, at the kernel's rounding points.

    x0 (N, M) f32; mask (N, U) nonzero = valid key; cache_kv (L, N, 2U, M) and
    act_kv (L, N, 2, 128, M) the fused paged cache with its ``table`` and
    ``act_src``; ``wall``/``vecs`` from :func:`prepare_lm_megastep`. int8
    caches: ``k_scale``/``v_scale`` (L, N, U) f32; each layer's fresh k/v
    (the bf16-rounded projections) go through ``quantize_rows``, cached codes
    dequantize element by element. Returns ``(x_out (N, M) f32, cache_kv,
    act_kv)``: the caches are the operands, with every layer's merged active
    page (and, int8, its scales at ``step``) written in place.
    """
    layers, d_ffn = _check(x0, mask, cache_kv, act_kv, table, act_src, step, wall, vecs, nhead,
                           k_scale, v_scale)
    m = x0.shape[1]
    nf = d_ffn // m
    nb = _nb(nf)
    cache = {"kv": cache_kv, "kv_act": act_kv, "table": table, "act_src": act_src}
    if cache_kv.dtype == torch.int8:
        cache.update(k_scale=k_scale, v_scale=v_scale)
    x = x0
    for layer in range(layers):
        w = wall[layer * nb:(layer + 1) * nb].float()
        vec = vecs[layer]
        xb = _bf16(x)
        q, kh, vh = (_bf16(xb @ w[j] + vec[j]) for j in range(3))
        ctx = _paged_plain(q, kh, vh, mask, cache, step, layer, nhead)
        x = _layer_norm(x + (_bf16(ctx) @ w[3] + vec[3]), vec[5 + nf], vec[6 + nf])
        w1 = torch.cat([w[4 + 2 * c] for c in range(nf)], dim=1)  # (M, F)
        w2 = torch.cat([w[5 + 2 * c] for c in range(nf)], dim=0)  # (F, M)
        b1 = vec[4:4 + nf].reshape(-1)
        hid = _bf16(F.gelu(_bf16(x) @ w1 + b1, approximate="none" if exact_gelu else "tanh"))
        x = _layer_norm(x + (hid @ w2 + vec[4 + nf]), vec[7 + nf], vec[8 + nf])
    return x, cache_kv, act_kv


_fn = None  # the bound C entry point, set on first launch


def _entry():
    """``sa_lm_megastep`` with its argument types, bound once."""
    global _fn
    if _fn is None:
        from ..utils import cuda_build

        fn = cuda_build.load("lm_megastep").sa_lm_megastep
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(x0, mask, cache_kv, act_kv, table, act_src, step, wall, vecs, nhead, exact_gelu,
            k_scale, v_scale, layers, d_ffn) -> torch.Tensor:
    n, m = x0.shape
    u = cache_kv.shape[2] // 2
    dev = x0.device
    xs = torch.empty(n, m, dtype=torch.float32, device=dev)
    xb = torch.empty(n, m, dtype=torch.bfloat16, device=dev)  # bf16(x): the products' operand
    qkv = torch.empty(3, n, m, dtype=torch.float32, device=dev)
    ctx = torch.empty(n, m, dtype=torch.bfloat16, device=dev)
    # the K-slice sums of the out-projection (2 slices) and of W2 (d_ffn / m)
    part = torch.empty(max(d_ffn // m, 2), n, m, dtype=torch.float32, device=dev)
    hid = torch.empty(n, d_ffn, dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ks, vs = ((k_scale.data_ptr(), v_scale.data_ptr()) if cache_kv.dtype == torch.int8
              else (0, 0))
    err = _entry()(x0.data_ptr(), mask.data_ptr(), cache_kv.data_ptr(), act_kv.data_ptr(),
                   table.data_ptr(), act_src.data_ptr(), wall.data_ptr(), vecs.data_ptr(), ks, vs,
                   xs.data_ptr(), xb.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), part.data_ptr(),
                   hid.data_ptr(),
                   n, u, m, nhead, layers, d_ffn, step, _DTYPE_CODES[cache_kv.dtype],
                   int(exact_gelu), dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"lm_megastep kernel launch failed: CUDA error {err}")
    return xs


def lm_megastep(x0, mask, cache_kv, act_kv, table, act_src, step: int, wall, vecs, nhead: int,
                exact_gelu: bool = False, k_scale=None, v_scale=None):
    """K7 (counts one in ``lm_megastep.launches``, and with ``exact_gelu`` in
    ``lm_megastep.exact_launches``); arguments and outputs as
    :func:`lm_megastep_plain`, which it runs only for CPU tensors."""
    operands = (x0, mask, cache_kv, act_kv, table, act_src, step, wall, vecs, nhead)
    device = cache_kv.device
    if device.type == "cpu":
        return lm_megastep_plain(*operands, exact_gelu, k_scale, v_scale)
    if device.type != "cuda":
        raise ValueError(f"lm_megastep runs on cuda or cpu, not {device}")
    layers, d_ffn = _check(*operands, k_scale, v_scale)
    if cache_kv.dtype == torch.int8:
        check_int8_chunked_head(x0.shape[1] // nhead)
    x = _launch(*operands, exact_gelu, k_scale, v_scale, layers, d_ffn)
    lm_megastep.launches += 1
    lm_megastep.exact_launches += bool(exact_gelu)
    return x, cache_kv, act_kv


lm_megastep.launches = 0
lm_megastep.exact_launches = 0

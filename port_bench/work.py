"""The yardstick's table of peaks and the operations and bytes of the kernels.

Frozen copies of the smoke run's formulas (``chip_smoke.py`` ``ops_ms``,
``k1_measure``'s counts, ``_paged_cache_bytes``, ``_mask_table_bytes``,
``_paged_bytes``, the paged attention's operations and ``_k7_work``), taken
as functions of shapes and of a launch's own mask, page table and parents,
so that a change to the kernels cannot change what they are held to. Each
input byte counts once and each output byte once.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

import torch

PEAK_FP32_FLOPS = 67e12        # outside the tensor cores
PEAK_TF32_TC_FLOPS = 495e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12     # HBM3

PEAKS = {"fp32": PEAK_FP32_FLOPS, "tf32": PEAK_TF32_TC_FLOPS, "bf16": PEAK_BF16_TC_FLOPS}


def ops_s(flops: float = 0.0, tc_flops: float = 0.0, tf32_flops: float = 0.0) -> float:
    """Least seconds for ``flops`` at the fp32 peak and, on the tensor cores
    at once, ``tc_flops`` at the bf16 and ``tf32_flops`` at the TF32 peak."""
    return max(flops / PEAK_FP32_FLOPS, tc_flops / PEAK_BF16_TC_FLOPS + tf32_flops / PEAK_TF32_TC_FLOPS)


def least_s(nbytes: float, flops: float = 0.0, tc_flops: float = 0.0, tf32_flops: float = 0.0) -> float:
    """The roofline's least time: the longer of the operations and the bytes."""
    return max(ops_s(flops, tc_flops, tf32_flops), nbytes / PEAK_BYTES_PER_S)


def k1_work(rows: int, win: int = 400, n_bins: int = 201, n_mels: int = 80) -> dict:
    """K1 (frames -> mel power) on ``rows`` frames: the DFT product in three
    TF32 passes over the 2 * n_bins columns, re^2 + im^2 in fp32, the mel
    product in fp32 beside the tensor cores or in three TF32 passes,
    whichever bounds lower; bytes: the frames, the DFT operand (TF32 halves,
    win x 8 * ceil(2 * n_bins / 8) x 2 floats), the filters, the output."""
    dft_tf32 = 3 * 2 * rows * win * 2 * n_bins
    power, mel_fp32 = 3 * rows * n_bins, 2 * rows * n_bins * n_mels
    split = min(({"flops": power + mel_fp32, "tf32_flops": dft_tf32},
                 {"flops": power, "tf32_flops": dft_tf32 + 3 * mel_fp32}), key=lambda k: ops_s(**k))
    frag = win * 8 * (-(-2 * n_bins // 8)) * 2
    nbytes = 4 * (rows * win + frag + n_bins * n_mels + rows * n_mels)
    return {**split, "bytes": nbytes}


def paged_cache_bytes(table, act_src, mask, step: int, u: int, m: int, itemsize: int) -> int:
    """Cache bytes one layer's paged step must move: each distinct (owner
    row, position) of the completed pages that some reader row holds valid,
    each parent's active positions (copied whole into the merged page), and
    the merged page's writeback."""
    n, up = table.shape
    page = u // up
    p_act, o = divmod(step, page)
    pos = torch.arange(p_act * page, device=table.device)
    owner_pos = table[:, pos // page].long() * u + pos
    main = int(torch.unique(owner_pos[mask[:, :p_act * page]]).numel())
    active = int(torch.unique(act_src).numel()) * o
    return 2 * (main + active + n * (o + 1)) * m * itemsize


def mask_table_bytes(n: int, up: int, u: int, step: int) -> int:
    """The mask up to the step, the table's completed columns and act_src."""
    p_act = step // (u // up)
    return n * (step + 1) + 4 * (n * p_act + n)


def paged_attention_work(table, mask, step: int, u: int, m: int, nhead: int, cache_bytes: int) -> dict:
    """One K5/K6 launch (one layer) whose layer moves ``cache_bytes``
    (:func:`paged_cache_bytes`): the scores and the weighted sum over the
    valid positions, the softmax's exponentials; bytes: the cache bytes,
    q/k/v/out and the mask and table."""
    n = table.shape[0]
    valid = int(mask[:, :step + 1].sum())
    return {"flops": 4 * valid * m + n * nhead * (step + 1),
            "bytes": cache_bytes + 4 * n * m * 4 + mask_table_bytes(n, table.shape[1], u, step)}


def k7_work(table, mask, step: int, u: int, m: int, nhead: int, layers: int, d_ffn: int, cache_bytes: int) -> dict:
    """One K7 launch (every LM layer of one step, each moving ``cache_bytes``)
    on this step's valid positions: the attention in fp32, the layers'
    products on the bf16 tensor cores; bytes: the layers' cache bytes, the
    mask and table once, the stacked bf16 weights (layers x (4 M^2 + 2 M
    F)), the f32 vectors (layers x (9 M + F): biases and norms) and x in and
    out."""
    n = table.shape[0]
    valid = int(mask[:, :step + 1].sum())
    wall, vecs = layers * (4 * m * m + 2 * m * d_ffn), layers * (9 * m + d_ffn)
    return {"flops": layers * (4 * valid * m + n * nhead * (step + 1)),
            "tc_flops": 2 * n * m * m * (4 + 2 * (d_ffn // m)) * layers,
            "bytes": layers * cache_bytes + mask_table_bytes(n, table.shape[1], u, step) + wall * 2 + vecs * 4
            + 2 * n * m * 4}


def paged_bytes_memo(memo: dict, table, act_src, mask, step: int, u: int, m: int, itemsize: int) -> int:
    """:func:`paged_cache_bytes`, once for each step's tensors (the layers of
    one step share them)."""
    key = (id(mask), id(table), id(act_src), step, m, itemsize)
    if key not in memo:
        memo[key] = paged_cache_bytes(table, act_src, mask, step, u, m, itemsize)
    return memo[key]


def paged_launch(mask, cache: dict, step: int, nhead: int, chunked: bool):
    """What a paged attention launch keeps for its work (the step's mask,
    table and parents, which the decode makes anew each step), if the launch
    takes the chunked kernel (K6) where ``chunked`` and the whole-row one
    (K5) where not; else None."""
    from speech_anonymization_tpu_torch.ops import attention_step_paged

    main = cache["kv"] if "kv" in cache else cache["k"]
    if chunked != ("kv" in cache or attention_step_paged.uses_chunked(mask.shape[1], main.shape[-1], main.dtype)):
        return None
    return (mask, cache["table"], cache["act_src"], step, cache["tokens"].shape[1], main.shape[-1], nhead,
            main.element_size())


def paged_launches_work(kept: list) -> list:
    """:func:`paged_attention_work` of each kept paged attention launch."""
    memo: dict = {}
    return [paged_attention_work(table, mask, step, u, m, nhead,
                                 paged_bytes_memo(memo, table, act_src, mask, step, u, m, itemsize))
            for mask, table, act_src, step, u, m, nhead, itemsize in kept]

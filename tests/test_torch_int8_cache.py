"""The int8 cache plumbing of the port (``decode_cache_dtype: int8``) against
the JAX package (CPU): the quantizer, the cache's keys and shapes (whole-row,
and above the whole-row bound, where U rounds to 64 and a paged cache is
fused by 64), and the beam reorder of the scales.

The quantizer (``ops.attention_step.quantize_rows``, which the K3/K5 twins
and ``make_attends``' finalize run, and which the kernels compute on the card)
equals ``finalize_jnp`` bit for bit, codes and scales, on rows with exact .5
ties (round half to even), all-zero rows (the 1e-6 floor) and rows whose
maximum sits in each head in turn. ``finalize_jnp`` runs eagerly here: under
``jax.jit`` XLA rewrites its ``amax / 127.0`` as ``amax * (1 / 127)`` (the
TPU kernel's form), which can differ in the last bit; the contract is the
division.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.transformer import MultiHeadAttention, _make_attends
from speech_anonymization_tpu.models.transformer import beam_reorder_cache as jax_reorder
from speech_anonymization_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from speech_anonymization_tpu_torch.models.transformer import (
    beam_reorder_cache,
    make_attends,
    make_kv_cache,
)
from speech_anonymization_tpu_torch.ops.attention_step import max_u_whole_row, quantize_rows
from tests.torch_port_helpers import t

L, N, H, D = 2, 8, 4, 32
M = H * D


def _rows(kind: str, rng) -> np.ndarray:
    """(L, N, M) f32 fresh rows of one kind."""
    x = (rng.standard_normal((L, N, M)) * rng.uniform(1e-3, 1e3, (L, N, 1))).astype(np.float32)
    if kind == "ties":
        # amax 127 makes 127 / amax exactly 1, amax 63.5 makes it 2: every
        # value below is then an exact .5 tie after the scaling
        x = rng.choice(np.arange(-20, 20) + 0.5, size=(L, N, M)).astype(np.float32)
        x[..., 0] = 127.0
        x[1, ::2] = x[1, ::2] / 2  # amax 63.5: x * 2 = k + .5 again
        x[1, ::2, 0] = -63.5
    elif kind == "zeros":
        x[:, ::2] = 0.0
        x[:, 1::4] *= 1e-9  # nonzero, below the 1e-6 floor
    elif kind == "max_in_head":
        for n in range(N):
            head = n % H  # the row's largest |x| in this head, either sign
            x[:, n, head * D + (n * 7) % D] = (-1) ** n * 50 * np.abs(x[:, n]).max()
    assert x.dtype == np.float32
    return x


@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "max_in_head"])
def test_quantizer_matches_finalize_jnp(kind):
    """``quantize_rows`` and the port's physical ``finalize`` against JAX's
    ``finalize_jnp``: codes and scales bit for bit."""
    rng = np.random.default_rng(len(kind))
    ks, vs = _rows(kind, rng), _rows(kind, rng)[::-1].copy()
    step, u = 5, 16
    jcache = jax_make_kv_cache(N, u, L, H, D, dtype=jnp.int8)
    mask = jnp.ones((N, u), bool)
    _, finalize = _make_attends([None] * L, [MultiHeadAttention(M, H)] * L, jcache, mask, step, H)
    want = finalize([jnp.asarray(k[:, None]) for k in ks], [jnp.asarray(v[:, None]) for v in vs])

    codes, scales = quantize_rows(t(ks))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want["k"])[:, :, step])
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want["k_scale"])[:, :, step])
    if kind == "ties":  # half to even: 2.5 -> 2, -3.5 -> -4
        assert codes.numpy()[0, 0, 0] == 127 and (np.abs(codes.numpy()) % 2 == 0).mean() > 0.9

    pcache = make_kv_cache(N, u, L, H, D, torch.int8, device="cpu")
    _, finalize_plain = make_attends([None] * L, pcache, torch.ones(N, u, dtype=torch.bool), step, H)
    finalize_plain([t(k[:, None]) for k in ks], [t(v[:, None]) for v in vs])
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(pcache[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("u_max", [1, 40, 424])
def test_make_kv_cache_int8_matches_jax(paged, u_max):
    """Keys, shapes and dtypes of JAX's int8 cache (the port adds the physical
    layout's spare pair, the buffers the K2 reorder gathers into)."""
    want = jax_make_kv_cache(N, u_max, L, 8, 96, dtype=jnp.int8, paged=paged)
    got = make_kv_cache(N, u_max, L, 8, 96, torch.int8, device="cpu", paged=paged)
    assert set(got) - {"k_spare", "v_spare"} == set(want)
    for key, value in want.items():
        assert tuple(got[key].shape) == value.shape, key
        # the port's token buffer is int64, torch's index type
        assert got[key].dtype == (torch.long if key == "tokens" else getattr(torch, str(value.dtype)))
        if key not in ("table", "act_src"):
            assert not got[key].any(), key


@pytest.mark.parametrize("u_max,paged", [(425, False), (425, True), (1000, True), (1000, False)])
def test_int8_above_the_whole_row_bound_raises(u_max, paged):
    """Above ``max_u_whole_row(M, 2)`` (426 at M 768) an int8 cache is made,
    as JAX's: U rounds to a multiple of 64 (448, 1024), a paged one takes
    the fused page-64 layout K6 and K7 read, and the scales are (L, N, U);
    keys, shapes and dtypes equal JAX's (the physical layout adds its spare
    pair). Nothing raises."""
    assert max_u_whole_row(768, 2) == 426
    want = jax_make_kv_cache(N, u_max, L, 8, 96, dtype=jnp.int8, paged=paged)
    got = make_kv_cache(N, u_max, L, 8, 96, torch.int8, device="cpu", paged=paged)
    u = 448 if u_max == 425 else 1024
    assert set(got) - {"k_spare", "v_spare"} == set(want)
    for key, value in want.items():
        assert tuple(got[key].shape) == value.shape, key
    assert got["k_scale"].shape == got["v_scale"].shape == (L, N, u)
    assert got["k_scale"].dtype == torch.float32 and got["tokens"].shape == (N, u)
    if paged:
        assert got["kv"].shape == (L, N, 2 * u, 768) and got["kv"].dtype == torch.int8
        assert got["kv_act"].shape == (L, N, 2, 128, 768) and got["table"].shape == (N, u // 64)
    else:
        assert got["k"].shape == got["k_spare"].shape == (L, N, u, 768)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("step", [3, 31])
def test_reorder_moves_the_scales_like_jax(paged, step):
    """Non-identity parents gather ``k_scale``/``v_scale`` along N in both
    layouts, as JAX does. Paged, the codes stay and the scales must move
    (they are indexed by each row's own position): a reorder that left them
    would keep the old row's scales beside the new parent's pages."""
    b, k = 2, 4
    rng = np.random.default_rng(step + paged)
    jc = jax_make_kv_cache(b * k, 64, L, H, D, dtype=jnp.int8, paged=paged)
    pc = make_kv_cache(b * k, 64, L, H, D, torch.int8, device="cpu", paged=paged)
    for key in ("k_scale", "v_scale"):
        values = rng.uniform(0.001, 1.0, jc[key].shape).astype(np.float32)
        jc[key] = jnp.asarray(values)
        pc[key].copy_(t(values))
    for key in ("k", "v"):
        codes = rng.integers(-127, 128, jc[key].shape).astype(np.int8)
        jc[key] = jnp.asarray(codes)
        pc[key].copy_(t(codes))
    parent = np.array([[3, 3, 0, 1], [2, 0, 0, 3]])
    assert (parent != np.arange(k)).any()
    want = jax_reorder(jc, jnp.asarray(parent, jnp.int32), step)
    got = beam_reorder_cache(pc, t(parent), step)
    src = (np.arange(b)[:, None] * k + parent).reshape(-1)
    for key in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        np.testing.assert_array_equal(got[key].numpy(), pc[key].numpy()[:, src])
    if paged:
        for key in ("table", "act_src"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert got["k"] is pc["k"]  # the codes never move
    else:
        for key in ("k", "v"):
            np.testing.assert_array_equal(got[key][:, :, :step + 1].numpy(),
                                          np.asarray(want[key])[:, :, :step + 1])

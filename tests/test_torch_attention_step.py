"""K3/K4's plain twin, ``attention_step_plain``, against the JAX package (CPU).

f32 caches: against the reference math the JAX package runs off the TPU,
``MultiHeadAttention.attend_cached`` + ``finalize_jnp`` (through
``_make_attends``' plain branch), at atol 2e-4 (tests/test_cached_decode.py:42).
bf16 caches: against the TPU kernel itself, ``cached_attention_step`` in
interpret mode, at 2e-2 relative to the largest output
(tests/test_attention_step_kernel.py:52). Shapes: whole-row (L 2, N 8, U 16,
M 256) and the chunked shape of the JAX kernel test (M 768, U 448). Inputs
include a masked fresh token and NaN/Inf beyond the step. int8 caches: the
whole-row shape, and the chunked one at U 512 (the 30 s shape's U, above the
int8 whole-row bound of 426), where the JAX kernel is ``_kernel_chunked``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.transformer import MultiHeadAttention, _make_attends
from speech_anonymization_tpu.ops.pallas.attention_step import cached_attention_step
from speech_anonymization_tpu_torch.ops import attention_step as port
from speech_anonymization_tpu_torch.ops.attention_step import attention_step_plain
from tests.torch_port_helpers import t

SHAPES = {"whole_row": (2, 8, 16, 256, 4), "chunked": (2, 8, 448, 768, 8),
          "int8_chunked": (2, 8, 512, 768, 8)}


def _inputs(shape, step, seed, masked_fresh):
    layers, n, u, m, _ = shape
    rng = np.random.default_rng(seed)
    q, kh, vh = (rng.standard_normal((n, m)).astype(np.float32) for _ in range(3))
    mask = rng.random((n, u)) > 0.2
    mask[:, 0] = True
    mask[:, step] = True
    if masked_fresh:
        mask[::2, step] = False  # every other row's fresh token is a pad key
    ck, cv = (rng.standard_normal((layers, n, u, m)).astype(np.float32) for _ in range(2))
    for c in (ck, cv):  # stale bytes beyond the step
        c[:, :, step + 1:] = np.nan
        c[:, :, step + 2:, ::5] = np.inf
    return q, kh, vh, mask, ck, cv


CASES = [("whole_row", 0, False), ("whole_row", 7, True), ("whole_row", 15, False),
         ("chunked", 3, False), ("chunked", 200, True), ("chunked", 440, False)]


@pytest.mark.parametrize("name,step,masked_fresh", CASES)
def test_f32_matches_attend_cached(name, step, masked_fresh):
    shape = SHAPES[name]
    layers, n, u, m, nhead = shape
    q, kh, vh, mask, ck, cv = _inputs(shape, step, seed=step, masked_fresh=masked_fresh)
    d = m // nhead
    cache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    attends, finalize = _make_attends([None] * layers, [MultiHeadAttention(m, nhead)] * layers,
                                      cache, jnp.asarray(mask), step, nhead)
    want = np.asarray(attends[1](*(jnp.asarray(x).reshape(n, 1, nhead, d) for x in (q, kh, vh))))
    new = finalize(*([jnp.asarray(x).reshape(n, 1, m)] * layers for x in (kh, vh)))

    pk, pv = t(ck), t(cv)
    got = attention_step_plain(t(q), t(kh), t(vh), t(mask), pk, pv, step, 1, nhead)
    np.testing.assert_allclose(got.numpy(), want.reshape(n, m), atol=2e-4)
    # the fresh k/v at (layer 1, :, step), as finalize_jnp writes it
    np.testing.assert_array_equal(pk[1, :, :step + 1].numpy(), np.asarray(new["k"])[1, :, :step + 1])
    np.testing.assert_array_equal(pv[1, :, :step + 1].numpy(), np.asarray(new["v"])[1, :, :step + 1])
    np.testing.assert_array_equal(pk[0].numpy(), ck[0])  # the other layer is untouched


@pytest.mark.parametrize("name,step,masked_fresh", CASES)
def test_bf16_matches_tpu_kernel_interpret(name, step, masked_fresh):
    shape = SHAPES[name]
    _, _, _, _, nhead = shape
    q, kh, vh, mask, ck, cv = _inputs(shape, step, seed=100 + step, masked_fresh=masked_fresh)
    jk, jv = (jnp.asarray(c).astype(jnp.bfloat16) for c in (ck, cv))
    want, nck, ncv = cached_attention_step(jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh),
                                           jnp.asarray(mask.astype(np.int8)), jk, jv, step, 1,
                                           nhead, interpret=True)
    want = np.asarray(want)
    pk, pv = (t(np.asarray(c.astype(jnp.float32))).to(torch.bfloat16) for c in (jk, jv))
    got = attention_step_plain(t(q), t(kh), t(vh), t(mask), pk, pv, step, 1, nhead)
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < 2e-2, rel
    for port_cache, jax_cache in ((pk, nck), (pv, ncv)):
        np.testing.assert_array_equal(port_cache[1, :, step].float().numpy(),
                                      np.asarray(jax_cache[1, :, step].astype(jnp.float32)))


@pytest.mark.parametrize("name,chunked", [("whole_row", False), ("chunked", True)])
def test_dispatch_rule_matches_jax(name, chunked):
    """The port picks K3/K4 by the JAX rule (``_attn_step_call:1167``)."""
    _, _, u, m, _ = SHAPES[name]
    assert port.uses_chunked(u, m, torch.bfloat16) is chunked
    assert port.max_u_whole_row(768, 4) == 213 and port.max_u_whole_row(768, 2) == 426
    assert not port.uses_chunked(213, 768, torch.float32)
    assert port.uses_chunked(214, 768, torch.float32)


def test_cpu_wrappers_take_the_plain_twin():
    q, kh, vh, mask, ck, cv = _inputs(SHAPES["whole_row"], 5, seed=1, masked_fresh=False)
    counts = (port.attention_step.launches, port.attention_step_chunked.launches)
    want = attention_step_plain(t(q), t(kh), t(vh), t(mask), t(ck), t(cv), 5, 0, 4)
    for kernel in (port.attention_step, port.attention_step_chunked, port.cached_attention_step):
        got = kernel(t(q), t(kh), t(vh), t(mask), t(ck), t(cv), 5, 0, 4)
        assert torch.equal(got, want)
    assert (port.attention_step.launches, port.attention_step_chunked.launches) == counts


def _int8_inputs(shape, step, seed, masked_fresh, bf16_fresh=False):
    """int8 codes and (L, N, U) scales, NaN scales and code -128 (which the
    quantizer never writes) beyond the step; ``bf16_fresh``: q/kh/vh that
    bf16 represents exactly (the TPU kernel rounds them to bf16 on entry, so
    both quantize the same kh/vh)."""
    layers, n, u, m, _ = shape
    q, kh, vh, mask, _, _ = _inputs(shape, step, seed, masked_fresh)
    if bf16_fresh:
        q, kh, vh = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
                     for x in (q, kh, vh))
    rng = np.random.default_rng(seed + 1)
    ck, cv = (rng.integers(-127, 128, (layers, n, u, m)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.002, 0.05, (layers, n, u)).astype(np.float32) for _ in range(2))
    for c, s in ((ck, ks), (cv, vs)):
        c[:, :, step + 1:] = -128
        s[:, :, step + 1:] = np.nan
    return q, kh, vh, mask, ck, cv, ks, vs


# int8: the whole-row cases; against the TPU kernel also two chunked ones
# (K4's twin against ``_kernel_chunked``), one with the fresh token masked
INT8_CASES = [case for case in CASES if case[0] == "whole_row"]
INT8_KERNEL_CASES = INT8_CASES + [("int8_chunked", 64, True), ("int8_chunked", 447, False)]


@pytest.mark.parametrize("name,step,masked_fresh", INT8_CASES)
def test_int8_matches_attend_cached(name, step, masked_fresh):
    """int8 caches: the twin against ``attend_cached`` + ``finalize_jnp`` (run
    eagerly, as the reference's own division) at atol 1e-5, the written codes
    and scales bit for bit."""
    shape = SHAPES[name]
    layers, n, u, m, nhead = shape
    q, kh, vh, mask, ck, cv, ks, vs = _int8_inputs(shape, step, 300 + step, masked_fresh)
    d = m // nhead
    cache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "k_scale": jnp.asarray(ks),
             "v_scale": jnp.asarray(vs)}
    attends, finalize = _make_attends([None] * layers, [MultiHeadAttention(m, nhead)] * layers,
                                      cache, jnp.asarray(mask), step, nhead)
    want = np.asarray(attends[1](*(jnp.asarray(x).reshape(n, 1, nhead, d) for x in (q, kh, vh))))
    new = finalize(*([jnp.asarray(x).reshape(n, 1, m)] * layers for x in (kh, vh)))

    pk, pv, pks, pvs = t(ck), t(cv), t(ks), t(vs)
    got = attention_step_plain(t(q), t(kh), t(vh), t(mask), pk, pv, step, 1, nhead, pks, pvs)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.reshape(n, m), atol=1e-5, rtol=0)
    for port_cache, key in ((pk, "k"), (pv, "v"), (pks, "k_scale"), (pvs, "v_scale")):
        np.testing.assert_array_equal(port_cache[1, :, :step + 1].numpy(),
                                      np.asarray(new[key])[1, :, :step + 1], err_msg=key)
    np.testing.assert_array_equal(pk[0].numpy(), ck[0])  # the other layer is untouched


@pytest.mark.parametrize("name,step,masked_fresh", INT8_KERNEL_CASES)
def test_int8_matches_tpu_kernel_interpret(name, step, masked_fresh):
    """int8 caches: the twin against the TPU kernel in interpret mode at its
    own int8 tolerance, 3e-2 relative to the largest output
    (tests/test_attention_step_kernel.py:168; it rounds q and the dequantized
    keys to bf16); codes equal, scales within one f32 ulp (the kernel's
    ``amax * (1 / 127)``)."""
    shape = SHAPES[name]
    _, n, _, m, nhead = shape
    q, kh, vh, mask, ck, cv, ks, vs = _int8_inputs(shape, step, 400 + step, masked_fresh,
                                                   bf16_fresh=True)
    want, nck, ncv, kso, vso = cached_attention_step(
        jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(mask.astype(np.int8)),
        jnp.asarray(ck), jnp.asarray(cv), step, 1, nhead, interpret=True,
        k_scale=jnp.asarray(ks[1]), v_scale=jnp.asarray(vs[1]))
    want = np.asarray(want)
    pk, pv, pks, pvs = t(ck), t(cv), t(ks), t(vs)
    got = attention_step_plain(t(q), t(kh), t(vh), t(mask), pk, pv, step, 1, nhead, pks, pvs)
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel < 3e-2, rel
    for port_cache, jax_cache in ((pk, nck), (pv, ncv)):
        np.testing.assert_array_equal(port_cache[1, :, step].numpy(),
                                      np.asarray(jax_cache[1, :, step]))
    for port_scale, jax_scale in ((pks, kso), (pvs, vso)):
        np.testing.assert_array_max_ulp(port_scale[1, :, step].numpy(),
                                        np.asarray(jax_scale)[:, 0], 1)


def test_int8_chunked_kernel_refuses():
    """K4 on int8 CPU tensors: ``cached_attention_step`` takes it above the
    int8 whole-row bound (U 512) and it runs the twin, codes and scales
    written alike, no launch counted; it refuses int8 codes without their
    scales."""
    shape = SHAPES["int8_chunked"]
    q, kh, vh, mask, ck, cv, ks, vs = _int8_inputs(shape, 100, 5, False)
    assert port.uses_chunked(shape[2], shape[3], torch.int8)
    want_buffers = [t(x) for x in (ck, cv, ks, vs)]
    want = attention_step_plain(t(q), t(kh), t(vh), t(mask), *want_buffers[:2], 100, 1, 8,
                                *want_buffers[2:])
    launches = port.attention_step_chunked.launches
    for kernel in (port.attention_step_chunked, port.cached_attention_step):
        buffers = [t(x) for x in (ck, cv, ks, vs)]
        got = kernel(t(q), t(kh), t(vh), t(mask), *buffers[:2], 100, 1, 8, *buffers[2:])
        assert torch.equal(got, want)
        for x, y in zip(buffers, want_buffers):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    assert port.attention_step_chunked.launches == launches
    with pytest.raises(TypeError, match="k_scale"):
        port._check(t(q), t(kh), t(vh), t(mask), t(ck), t(cv), 3, 0, 8, None, None)


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("d_head", [96, 64])
def test_whole_row_layout_fits(d_head, itemsize):
    """K3's ring and shared memory at every step of every U the whole-row
    kernel serves at M 768 (213 positions for f32, 426 for bf16 and int8):
    within K3_SMEM (eight blocks an H100 SM, far within a block's 227 KB),
    with two slots or more wherever a launch has two loads or more, none at
    step 0, and no slot past the launch's loads."""
    u_max = port.max_u_whole_row(768, max(itemsize, 2))
    for step in range(u_max):
        chunk, slots, smem = port.whole_row_layout(step, d_head, itemsize)
        loads = 2 * -(-step // chunk)
        assert min(loads, 2) <= slots <= loads, step
        assert smem <= port.K3_SMEM, step


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_k3_launch_takes_the_layout_rule(monkeypatch, dtype):
    """K3's launch hands the C entry the cache's layers and whole_row_layout's
    ring and shared memory (which the kernel refuses unless they agree with
    its own); K4's launch hands it none."""
    shape = (2, 8, 72, 768, 8)
    if dtype == torch.int8:
        q, kh, vh, mask, ck, cv, ks, vs = (t(x) for x in _int8_inputs(shape, 40, 3, False))
        scales = (ks, vs)
    else:
        q, kh, vh, mask, ck, cv = (t(x) for x in _inputs(shape, 40, seed=3, masked_fresh=False))
        ck, cv, scales = ck.to(dtype), cv.to(dtype), (None, None)
    calls = []
    monkeypatch.setattr(port, "_entry", lambda: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0}))
    for chunked in (False, True):
        port._launch(chunked, q, kh, vh, mask, ck, cv, 40, 1, 8, *scales)
    k3, k4 = (args[9:-2] for args in calls)
    common = (2, 8, 72, 768, 8, 40, 1, {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[dtype])
    assert k3 == (*common, 0, *port.whole_row_layout(40, 96, dtype.itemsize))
    assert k4 == (*common, 1, 0, 0, 0)

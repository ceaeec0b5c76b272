"""The int8 chunked kernels' arithmetic against the JAX package (CPU).

``attend_int8_tiled`` is the plain-PyTorch form of ``csrc/attention_step.cuh``
``attn_step_chunked_i8`` (K4, K6 and K7's attention on int8 caches): the
scales factored out of the products, q and the scaled softmax weights split
into three f16 terms, f32 sums tile by tile in the kernel's order. Held here
to the JAX package's reference math (``attend_cached`` + ``finalize_jnp``)
at atol 1e-5 (the twin's own tolerance, tests/test_torch_attention_step.py),
to the JAX chunked Pallas kernel (``_kernel_chunked``) in interpret mode at
its int8 tolerance, 3e-2 relative to the largest output (it rounds q and the
dequantized keys to bf16), and to the port's plain twin at 1e-5. Shapes: 2
layers, 8 rows, U 128 (tiles of 16 and the JAX kernel's chunks crossed),
heads of 96 and 64; steps 0, 63, 64 and 127; pad keys, a masked fresh token,
and code -128 with NaN scales wherever the step may not read. On the card,
tests/test_torch_cuda.py holds the kernels to this emulation. Also here: the
head widths the card's int8 chunked body takes, and how
tools/profile_chunked.py reads nvcc's report.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.transformer import MultiHeadAttention, _make_attends
from speech_anonymization_tpu.ops.pallas import attention_step as jax_attention_step
from speech_anonymization_tpu_torch.ops.attention_step import (
    I8_CHUNKED_HEADS,
    _f16_shift,
    _f16_terms,
    _pow2,
    attend_int8_tiled,
    attend_plain,
    check_int8_chunked_head,
)
from speech_anonymization_tpu_torch.tools import profile_chunked
from tests.torch_port_helpers import t

LAYERS, N, U = 2, 8, 128
HEADS = {"4x96": (384, 4), "4x64": (256, 4)}
STEPS = [(0, False), (63, True), (64, False), (127, True)]
ATOL = 1e-5
TPU_REL = 3e-2


def _inputs(m, step, seed, masked_fresh, hide_masked, bf16_fresh=False):
    """Seeded q/kh/vh, mask, int8 codes and (L, N, U) scales: code -128 and
    NaN scales past the step and, with ``hide_masked``, at masked positions
    (the JAX reference reads those, the port's kernels do not)."""
    rng = np.random.default_rng(seed)
    q, kh, vh = (rng.standard_normal((N, m)).astype(np.float32) for _ in range(3))
    if bf16_fresh:  # the TPU kernel rounds them to bf16 on entry
        q, kh, vh = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
                     for x in (q, kh, vh))
    mask = rng.random((N, U)) > 0.2
    mask[:, 0] = True
    mask[:, step] = True
    if masked_fresh:
        mask[::2, step] = False
    ck, cv = (rng.integers(-127, 128, (LAYERS, N, U, m)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.002, 0.05, (LAYERS, N, U)).astype(np.float32) for _ in range(2))
    hidden = np.zeros((N, U), bool)
    hidden[:, step + 1:] = True
    if hide_masked:
        hidden[:, :step] |= ~mask[:, :step]
    for c, s in ((ck, ks), (cv, vs)):
        c[:, hidden] = -128
        s[:, hidden] = np.nan
    return q, kh, vh, mask, ck, cv, ks, vs


def _emulated(q, kh, vh, mask, ck, cv, ks, vs, step, nhead, layer=1):
    p = step + 1
    return attend_int8_tiled(t(q), t(kh), t(vh), t(mask), t(ck[layer, :, :p]),
                             t(cv[layer, :, :p]), step, nhead, t(ks[layer, :, :p]),
                             t(vs[layer, :, :p])).numpy()


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("step,masked_fresh", STEPS)
def test_emulation_matches_attend_cached(heads, step, masked_fresh):
    m, nhead = HEADS[heads]
    d = m // nhead
    q, kh, vh, mask, ck, cv, ks, vs = _inputs(m, step, 700 + step, masked_fresh, False)
    cache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv), "k_scale": jnp.asarray(ks),
             "v_scale": jnp.asarray(vs)}
    attends, _ = _make_attends([None] * LAYERS, [MultiHeadAttention(m, nhead)] * LAYERS, cache,
                               jnp.asarray(mask), step, nhead)
    want = np.asarray(attends[1](*(jnp.asarray(x).reshape(N, 1, nhead, d) for x in (q, kh, vh))))
    got = _emulated(q, kh, vh, mask, ck, cv, ks, vs, step, nhead)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want.reshape(N, m), atol=ATOL, rtol=0)


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("step,masked_fresh", STEPS)
def test_emulation_matches_tpu_kernel_interpret(heads, step, masked_fresh, monkeypatch):
    m, nhead = HEADS[heads]
    # shrink the whole-row bound so that U 128 takes _kernel_chunked
    monkeypatch.setattr(jax_attention_step, "_VMEM_BUDGET", 2 * 8 * m * 2 * 64)
    assert U > jax_attention_step.max_u_whole_row(m, 2)
    q, kh, vh, mask, ck, cv, ks, vs = _inputs(m, step, 800 + step, masked_fresh, False,
                                              bf16_fresh=True)
    want, *_ = jax_attention_step.cached_attention_step(
        jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(mask.astype(np.int8)),
        jnp.asarray(ck), jnp.asarray(cv), step, 1, nhead, interpret=True,
        k_scale=jnp.asarray(ks[1]), v_scale=jnp.asarray(vs[1]))
    want = np.asarray(want)
    got = _emulated(q, kh, vh, mask, ck, cv, ks, vs, step, nhead)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < TPU_REL, rel


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("step,masked_fresh", STEPS + [(15, False), (16, True), (17, False)])
def test_emulation_matches_plain_twin(heads, step, masked_fresh):
    """NaN scales and code -128 at masked positions too: neither reads them."""
    m, nhead = HEADS[heads]
    q, kh, vh, mask, ck, cv, ks, vs = _inputs(m, step, 900 + step, masked_fresh, True)
    p = step + 1
    want = attend_plain(t(q), t(kh), t(vh), t(mask), t(ck[1, :, :p]), t(cv[1, :, :p]), step,
                        nhead, t(ks[1, :, :p]), t(vs[1, :, :p])).numpy()
    got = _emulated(q, kh, vh, mask, ck, cv, ks, vs, step, nhead)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_f16_terms_hold_f32():
    """Three f16 terms after the shift hold an f32 value to 2^-30 of the
    shifted range's top (2^14), past f32's 2^-24 relative, down to values
    2^-20 of the largest; the shift puts the largest in [2^13, 2^14)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((64, 96)) *
                          np.exp2(rng.integers(-20, 1, (64, 96)))).astype(np.float32))
    for scale in (1e-20, 1e-3, 1.0, 7.0, 1e20):
        xs = x * scale
        amax = xs.abs().amax(-1)
        sh = _f16_shift(amax)
        shifted = xs * _pow2(sh)[:, None]
        top = shifted.abs().amax(-1)
        assert bool(((top >= 2.0 ** 13) & (top < 2.0 ** 14)).all())
        t0, t1, t2 = _f16_terms(shifted)
        err = (shifted.double() - (t0.double() + t1.double() + t2.double())).abs()
        assert float(err.max()) <= 2.0 ** (14 - 30)
    # 0 takes no shift; below 2^-86 and from 2^114 up the shift stops at +-100
    assert _f16_shift(torch.tensor([0.0, 1e-35, 1e36])).tolist() == [0, 100, -100]
    assert _pow2(torch.tensor([-126, 0, 127])).tolist() == [2.0 ** -126, 1.0, 2.0 ** 127]


def test_int8_chunked_head_widths():
    """The card's int8 chunked body takes heads of 32, 64, 96 or 128 (d_head
    / 16 tensor-core tiles, an even count); the wrappers refuse others there."""
    for d in I8_CHUNKED_HEADS:
        check_int8_chunked_head(d)
    for d in (16, 48, 80, 112, 144, 256):
        with pytest.raises(ValueError, match="head widths"):
            check_int8_chunked_head(d)


PTXAS = """ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__x22attn_step_chunked_int8ILb1ELi6EEEvNS_4ArgsIaEE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__x22attn_step_chunked_int8ILb1ELi6EEEvNS_4ArgsIaEE
    32 bytes stack frame, 28 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__x17attn_step_chunkedIfLb0EEEvNS_4ArgsIT_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__x17attn_step_chunkedIfLb0EEEvNS_4ArgsIT_EE
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 8 bytes cumulative stack size
"""


def test_profile_chunked_reads_the_build():
    """tools/profile_chunked.py: registers and spills from nvcc's report, the
    instantiation a case launches, and the blocks an SM they allow."""
    kernels = profile_chunked.parse_ptxas(PTXAS)
    k6 = profile_chunked.kernel_symbol(kernels, "int8", True, 96)
    k4 = profile_chunked.kernel_symbol(kernels, "float32", False, 96)
    assert kernels[k6] == (72, 28) and kernels[k4] == (48, 12)
    assert profile_chunked.kernel_symbol(kernels, "bfloat16", True, 64) is None
    smem = profile_chunked.kernel_smem(True, "int8", 96, 8)
    assert smem == 4 * 2 * (2 * 16 * 112 + 128) + 16 + 512 + 32
    assert profile_chunked.blocks_per_sm(72, smem) == 7
    assert profile_chunked.blocks_per_sm(48, profile_chunked.kernel_smem(False, "float32", 96, 0)) == 10

"""K7's plain twin and weight stacking against the JAX package (CPU).

* ``TransformerLM.prepare_megastep`` (through ``prepare_lm_megastep``):
  bit-identical to JAX's for the same weights;
* ``lm_megastep_plain`` against JAX's ``lm_megastep(..., interpret=True)``
  (the TPU kernel in Pallas interpret mode), each case from one seeded cache
  state: bf16-valued content, and a table and act_src from a simulated beam
  history whose reorders either coalesce every row of an utterance onto one
  parent (uniform page owners, the TPU kernel's shared-page path) or mix
  them. N 8, M 128, 2 heads of 64, 2 layers, d_ffn 256, U 128 (two pages of
  64), steps 5, 63 (completes page 0), 64 and 100; bf16 and f32 caches (JAX's
  interpret mode takes both). Tolerances, with the gaps measured here:
  x_out atol 3e-2 (0.007-0.014: the TPU kernel rounds each q.k product and
  each softmax weight to bf16, the twin keeps them in f32, as K6 does);
  the merged page's fresh k/v atol 3e-2 too (gap up to 0.0156: one bf16
  ulp on values near 3, and the second layer's k/v carry the first layer's
  x gap); the parent's copied positions and the slot the step reads
  exactly equal;
* one ``exact_gelu`` case (sb_compat LMs);
* int8 caches (codes with (L, N, U) scales, K7's int8 mode) at steps 63
  (mixed) and 64 (uniform), the content ``quantize_rows`` makes of the
  bf16 cases' (a real decode's codes and scales): x_out at X_ATOL (gap
  0.012-0.014; codes drawn uniformly in +-127 at scales to 0.05 give twice
  the magnitude and 0.027-0.043, as the TPU kernel's bf16 roundings of
  products and weights grow with the scores); the fresh codes at the JAX
  package's own tolerance for its megastep (``tests/test_lm_megastep.py``
  ``_codes_close``: within 3, more than 1 apart on under 2%) and the fresh
  scales at its rtol 0.02 (the two quantize k/v from bf16 products summed in
  other orders); the parent's copied codes and the slot the step reads
  exactly equal;
* the twin against the port's per-layer ``decode_step`` (f32 products) on the
  fused layout, through beam reorders and a page completion, at the JAX
  package's own megastep tolerance (log-probs rtol 0.1, atol 0.12);
* the wrapper on CPU tensors runs the twin and counts nothing; refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.transformer import TransformerLM as JaxLM
from speech_anonymization_tpu.ops.pallas.lm_megastep import lm_megastep as jax_megastep
from speech_anonymization_tpu_torch.models import TransformerLM
from speech_anonymization_tpu_torch.models.transformer import beam_reorder_cache
from speech_anonymization_tpu_torch.ops import lm_megastep as port
from speech_anonymization_tpu_torch.ops.attention_step import quantize_rows
from speech_anonymization_tpu_torch.ops.lm_megastep import lm_megastep_plain
from speech_anonymization_tpu_torch.utils.convert import lm_state_dict, load_numpy_state
from tests.torch_port_helpers import perturbed, t

V, M, H, L, FFN = 64, 128, 2, 2, 256
B, K = 2, 4
N = B * K
PAGE = 64
U = 2 * PAGE
X_ATOL = 3e-2  # x_out, and the fresh k/v the step writes


@functools.lru_cache(maxsize=None)
def _models():
    jl = JaxLM(vocab=V, d_model=M, nhead=H, num_layers=L, d_ffn=FFN, max_len=U + 8)
    v = perturbed(jax.jit(jl.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)), 5)
    pl = load_numpy_state(TransformerLM(vocab=V, d_model=M, nhead=H, num_layers=L, d_ffn=FFN,
                                        max_len=U + 8, device="cpu"), lm_state_dict(v)).eval()
    return jl, v, pl


def test_prepare_is_bit_identical_to_jax():
    jl, v, pl = _models()
    wj, vj = jl.prepare_megastep(v["params"])
    wp, vp = pl.prepare_megastep()
    assert wp.dtype == torch.bfloat16 and wp.shape == (L * (4 + 2 * FFN // M), M, M)
    np.testing.assert_array_equal(wp.view(torch.int16).numpy(), np.asarray(wj).view(np.int16))
    assert vp.dtype == torch.float32 and vp.shape == (L, 9 + FFN // M, M)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))


def _bf16_values(rng, shape):
    return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16).astype(jnp.float32))


def _state(step: int, history: str, seed: int):
    """A seeded fused cache state at ``step``: content, ownership after
    ``step`` reorders, x0 and a mask with pad keys."""
    rng = np.random.default_rng(seed)
    kv = _bf16_values(rng, (L, N, 2 * U, M))
    act = _bf16_values(rng, (L, N, 2, 2 * PAGE, M))
    table = np.repeat(np.arange(N, dtype=np.int32)[:, None], U // PAGE, axis=1)
    src = np.arange(N, dtype=np.int32)
    for s in range(step):
        coalesce = history == "uniform" or s % 2 == 0
        parent = np.zeros((B, K), int) if coalesce else rng.integers(0, K, (B, K))
        src = (np.arange(B)[:, None] * K + parent).reshape(-1).astype(np.int32)
        table = table[src]
        if s % PAGE == PAGE - 1:
            table[:, s // PAGE] = src
    x0 = rng.standard_normal((N, M)).astype(np.float32)
    mask = rng.random((N, U)) > 0.15
    mask[:, 0] = True
    return kv, act, table, src, x0, mask


def _written(kv, act, step):
    """(L, N, 2 * PAGE, M) merged page the step wrote: its main page when it
    completes one, else its parity slot."""
    p, o = divmod(step, PAGE)
    return kv[:, :, 2 * p * PAGE:2 * (p + 1) * PAGE] if o == PAGE - 1 else act[:, :, step % 2]


def _compare_with_jax(step, history, dtype, exact_gelu=False):
    jl, v, pl = _models()
    wj, vj = jl.prepare_megastep(v["params"])
    wp, vp = pl.prepare_megastep()
    kv, act, table, src, x0, mask = _state(step, history, seed=step)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}[dtype]
    x_j, kv_j, act_j = jax_megastep(jnp.asarray(x0), jnp.asarray(mask), jnp.asarray(kv, jdt),
                                    jnp.asarray(act, jdt), jnp.asarray(table), jnp.asarray(src),
                                    step, wj, vj, H, exact_gelu=exact_gelu, interpret=True)
    kv_p, act_p = t(kv).to(tdt), t(act).to(tdt)
    x_p, kv_out, act_out = lm_megastep_plain(t(x0), t(mask), kv_p, act_p, t(table), t(src), step,
                                             wp, vp, H, exact_gelu=exact_gelu)
    assert kv_out is kv_p and act_out is act_p  # written in place
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), atol=X_ATOL, rtol=0)
    f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))  # noqa: E731
    got, want = _written(kv_p.float().numpy(), act_p.float().numpy(), step), \
        _written(f32(kv_j), f32(act_j), step)
    o = step % PAGE
    for half in (0, PAGE):  # K then V: copied parent positions, then the fresh token
        np.testing.assert_array_equal(got[:, :, half:half + o], want[:, :, half:half + o])
        np.testing.assert_allclose(got[:, :, half + o], want[:, :, half + o], atol=X_ATOL,
                                   rtol=0)
    read = (step + 1) % 2
    np.testing.assert_array_equal(act_p[:, :, read].float().numpy(), f32(act_j)[:, :, read])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("step,history", [(5, "uniform"), (63, "mixed"), (64, "uniform"),
                                          (100, "mixed")])
def test_plain_matches_jax_interpret(dtype, step, history):
    _compare_with_jax(step, history, dtype)


def test_exact_gelu_matches_jax_interpret():
    _compare_with_jax(64, "mixed", "bf16", exact_gelu=True)


def _codes_close(got, want):
    """``tests/test_lm_megastep.py``'s int8 code tolerance."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 3, diff.max()
    assert (diff > 1).mean() < 0.02, (diff > 1).mean()


@pytest.mark.parametrize("step,history", [(63, "mixed"), (64, "uniform")])
def test_int8_matches_jax_interpret(step, history):
    jl, v, pl = _models()
    wj, vj = jl.prepare_megastep(v["params"])
    wp, vp = pl.prepare_megastep()
    kvf, actf, table, src, x0, mask = _state(step, history, seed=step)
    (kv, kv_scales), (act, _) = (quantize_rows(torch.from_numpy(x)) for x in (kvf, actf))
    kv, act = kv.numpy(), act.numpy()
    # each fused page is [K-page, V-page]: its rows' scales split into k's and v's
    paged = kv_scales.numpy().reshape(L, N, U // PAGE, 2, PAGE)
    ks, vs = (paged[:, :, :, j].reshape(L, N, U).copy() for j in (0, 1))
    x_j, kv_j, act_j, kso, vso = jax_megastep(
        jnp.asarray(x0), jnp.asarray(mask), jnp.asarray(kv), jnp.asarray(act), jnp.asarray(table),
        jnp.asarray(src), step, wj, vj, H, interpret=True, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    kv_p, act_p, ks_p, vs_p = t(kv), t(act), t(ks), t(vs)
    x_p, _, _ = lm_megastep_plain(t(x0), t(mask), kv_p, act_p, t(table), t(src), step, wp, vp, H,
                                  k_scale=ks_p, v_scale=vs_p)
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), atol=X_ATOL, rtol=0)
    got, want = _written(kv_p.numpy(), act_p.numpy(), step), _written(np.asarray(kv_j),
                                                                      np.asarray(act_j), step)
    o = step % PAGE
    for half in (0, PAGE):  # K then V: copied parent codes, then the fresh token's
        np.testing.assert_array_equal(got[:, :, half:half + o], want[:, :, half:half + o])
        _codes_close(got[:, :, half + o], want[:, :, half + o])
    read = (step + 1) % 2
    np.testing.assert_array_equal(act_p[:, :, read].numpy(), np.asarray(act_j)[:, :, read])
    for port_scale, jax_scale, before in ((ks_p, kso, ks), (vs_p, vso, vs)):
        np.testing.assert_allclose(port_scale[:, :, step].numpy(), np.asarray(jax_scale)[:, :, 0],
                                   rtol=0.02, atol=1e-6)
        np.testing.assert_array_equal(np.delete(port_scale.numpy(), step, axis=2),
                                      np.delete(before, step, axis=2))


def test_plain_matches_per_layer_decode():
    """The JAX package's own check of its kernel (``test_lm_megastep.py``),
    with the port's per-layer path as the reference: drive the state with
    it, and at check steps run the twin from the same state."""
    _, _, pl = _models()
    mega = pl.prepare_megastep()
    rng = np.random.default_rng(7)
    state = _state(0, "mixed", seed=7)
    cache = {"kv": t(state[0]) * 0, "kv_act": t(state[1]) * 0, "tokens": torch.zeros(N, U).long(),
             "table": t(state[2]), "act_src": t(state[3])}
    checks = {2, 5, PAGE - 1, PAGE, PAGE + 1, PAGE + 6}
    for step in range(PAGE + 7):
        tok = torch.from_numpy(rng.integers(3, V, N))
        twin_cache = {k: x.clone() for k, x in cache.items()}
        with torch.no_grad():
            ref, cache = pl.decode_step(tok, cache, step)
            if step in checks:
                x0 = pl.embed(tok) * M ** 0.5 + pl.pe[step]
                twin_cache["tokens"][:, step] = tok
                x, _, _ = lm_megastep_plain(x0, twin_cache["tokens"] != 0, twin_cache["kv"],
                                            twin_cache["kv_act"], twin_cache["table"],
                                            twin_cache["act_src"], step, *mega, H)
                np.testing.assert_allclose(torch.log_softmax(pl._head(x), -1).numpy(),
                                           torch.log_softmax(ref, -1).numpy(), rtol=0.1,
                                           atol=0.12, err_msg=f"step {step}")
        parent = np.zeros((B, K), int) if step % 3 == 0 else rng.integers(0, K, (B, K))
        cache = beam_reorder_cache(cache, torch.from_numpy(parent), step)


def test_cpu_wrapper_runs_the_twin():
    _, _, pl = _models()
    wall, vecs = pl.prepare_megastep()
    kv, act, table, src, x0, mask = _state(40, "mixed", seed=3)
    before = port.lm_megastep.launches
    outs = []
    for fn in (port.lm_megastep, lm_megastep_plain):
        kv_t, act_t = t(kv), t(act)
        x, _, _ = fn(t(x0), t(mask), kv_t, act_t, t(table), t(src), 40, wall, vecs, H)
        outs.append((x, kv_t, act_t))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert port.lm_megastep.launches == before


def _operands(case):
    """The wrapper's operands at step 5, with one broken as ``case`` names."""
    _, _, pl = _models()
    wall, vecs = pl.prepare_megastep()
    kv, act, table, src, x0, mask = (t(x) for x in _state(5, "mixed", seed=1))
    if case == "int8":  # int8 codes without their scales
        kv, act = kv.to(torch.int8), act.to(torch.int8)
    elif case == "split":  # the split layout's k cache and its k slots
        kv, act = kv[:, :, :U].contiguous(), act[:, :, :, :PAGE].contiguous()
    elif case == "page32":
        table = table.repeat_interleave(2, dim=1).contiguous()
    elif case == "misaligned":
        x0 = torch.empty(N * M + 1)[1:].view(N, M).copy_(x0)
    elif case == "strided":
        x0 = x0.t().contiguous().t()
    elif case == "blocks":
        wall = wall[:-1]
    return x0, mask, kv, act, table, src, 5, wall, vecs, H


@pytest.mark.parametrize("case,error", [("int8", TypeError), ("split", ValueError),
                                        ("page32", ValueError), ("misaligned", ValueError),
                                        ("strided", ValueError), ("blocks", ValueError)])
def test_refusals(case, error):
    with pytest.raises(error):
        port.lm_megastep(*_operands(case))


def test_int8_with_scales_accepted():
    """int8 codes with their (L, N, U) scales: the wrapper on CPU tensors runs
    the twin (x_out, codes and scales alike) and counts nothing."""
    x0, mask, kv, act, table, src, step, wall, vecs, _ = _operands("none")
    rng = np.random.default_rng(9)
    codes = [torch.from_numpy(rng.integers(-127, 128, x.shape).astype(np.int8)) for x in (kv, act)]
    scales = [torch.from_numpy(rng.uniform(0.002, 0.05, (L, N, U)).astype(np.float32))
              for _ in range(2)]
    before = port.lm_megastep.launches
    outs = []
    for fn in (port.lm_megastep, lm_megastep_plain):
        bufs = [x.clone() for x in (*codes, *scales)]
        x, _, _ = fn(x0, mask, *bufs[:2], table, src, step, wall, vecs, H, k_scale=bufs[2],
                     v_scale=bufs[3])
        outs.append((x, *bufs))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    assert port.lm_megastep.launches == before
    assert not torch.equal(outs[0][3][:, :, step], scales[0][:, :, step])  # written in place


def test_prepare_refuses_ffn_not_in_model_blocks():
    lm = TransformerLM(vocab=V, d_model=M, nhead=H, num_layers=1, d_ffn=M + 64, device="cpu")
    with pytest.raises(ValueError):
        lm.prepare_megastep()

"""K5/K6's plain twins, ``attention_step_paged_plain`` (split layout) and
``attention_step_paged_fused_plain`` (fused layout), against the JAX package
(CPU), through the paged protocol: a random beam reorder after every step,
across page completions.

f32 caches: every output against ``_make_attends_paged_jnp`` +
``attend_cached`` (the reference math JAX runs off the TPU) at atol 2e-4;
afterwards the logical content at positions <= the last step, rebuilt from
the pages, the table and the parity slots, equals a physically maintained
ground truth exactly. Page 32 (split), and page 64 split and fused at a small
M (the JAX function takes any cache dict).
bf16 caches: against the TPU kernels themselves in interpret mode
(``cached_attention_step_paged`` / ``_fused``) at 2e-2 relative to the
largest output, over three steps from a seeded mid-decode state that crosses
a page completion; the rebuilt content equals the kernels' exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (caps torch's threads)

from speech_anonymization_tpu.models.transformer import (
    MultiHeadAttention,
    _make_attends_paged_jnp,
)
from speech_anonymization_tpu.models.transformer import beam_reorder_cache as jax_reorder
from speech_anonymization_tpu.ops.pallas import attention_step as ats
from speech_anonymization_tpu_torch.models.transformer import beam_reorder_cache
from speech_anonymization_tpu_torch.ops import attention_step_paged as port
from speech_anonymization_tpu_torch.ops.attention_step_paged import (
    attention_step_paged_fused_plain,
    attention_step_paged_plain,
)

L, B, K, M, H = 2, 2, 4, 256, 4
N = B * K
# name: (page, fused, steps of the f32 protocol; the last one completes no page)
CONFIGS = {"page32_split": (32, False, 70), "page64_split": (64, False, 74),
           "page64_fused": (64, True, 74)}


def _zero_cache(page, fused, u, dtype=np.float32):
    cache = {"tokens": np.zeros((N, u), np.int32),
             "table": np.repeat(np.arange(N, dtype=np.int32)[:, None], u // page, axis=1),
             "act_src": np.arange(N, dtype=np.int32)}
    if fused:
        cache["kv"] = np.zeros((L, N, 2 * u, M), dtype)
        cache["kv_act"] = np.zeros((L, N, 2, 2 * page, M), dtype)
    else:
        for key in ("k", "v"):
            cache[key] = np.zeros((L, N, u, M), dtype)
            cache[f"{key}_act"] = np.zeros((L, N, 2, page, M), dtype)
    return cache


def _to_jax(cache, dtype=jnp.float32):
    return {k: jnp.asarray(v) if v.dtype.kind in "iu" else jnp.asarray(v, dtype)
            for k, v in cache.items()}


def _to_port(cache, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v)) if v.dtype.kind in "iu"
            else torch.from_numpy(np.asarray(v, np.float32)).to(dtype) for k, v in cache.items()}


def _logical(cache, page, last):
    """(L, N, last + 1, M) f32 k and v content of either layout, rebuilt from
    the completed pages through the table and the active page from the
    parity slot written at ``last`` (the caller has reordered after it)."""
    arr = {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v.astype(jnp.float32),
                         np.float32) for k, v in cache.items()}
    if "kv" in arr:
        layers, n, u2, m = arr["kv"].shape
        pages = arr["kv"].reshape(layers, n, u2 // (2 * page), 2, page, m)
        mains = [pages[:, :, :, i].reshape(layers, n, -1, m) for i in (0, 1)]
        acts = [arr["kv_act"][:, :, :, :page], arr["kv_act"][:, :, :, page:]]
    else:
        mains, acts = [arr["k"], arr["v"]], [arr["k_act"], arr["v_act"]]
    table, src = arr["table"].astype(int), arr["act_src"].astype(int)
    done = (last + 1) // page  # pages completed by the last step
    out = []
    for main, act in zip(mains, acts):
        got = np.zeros(main.shape[:2] + (last + 1, main.shape[3]), np.float32)
        for n in range(main.shape[1]):
            for p in range(done):
                got[:, n, p * page:(p + 1) * page] = main[:, table[n, p], p * page:(p + 1) * page]
            got[:, n, done * page:] = act[:, src[n], last % 2, :last + 1 - done * page]
        out.append(got)
    return out


@functools.lru_cache(maxsize=None)
def _jax_step(u):
    """Jitted reference step: every layer's attend, then finalize."""
    attns = [MultiHeadAttention(M, H)] * L
    d = M // H

    @jax.jit
    def step_fn(cache, q, kh, vh, mask, step):
        attends, finalize = _make_attends_paged_jnp(attns, cache, mask, step, H, False)
        outs = [attends[i](*(x[i].reshape(N, 1, H, d) for x in (q, kh, vh))) for i in range(L)]
        new = finalize([x.reshape(N, 1, M) for x in kh], [x.reshape(N, 1, M) for x in vh])
        return jnp.stack(outs).reshape(L, N, M), {**new, "tokens": cache["tokens"]}

    return step_fn


@pytest.mark.parametrize("name", list(CONFIGS))
def test_f32_protocol_matches_jax(name):
    page, fused, steps = CONFIGS[name]
    u = -(-(steps + 1) // page) * page
    rng = np.random.default_rng(page + fused)
    mask = rng.random((N, u)) > 0.2
    mask[:, 0] = True
    jcache = _to_jax(_zero_cache(page, fused, u))
    pcache = _to_port(_zero_cache(page, fused, u))
    twin = attention_step_paged_fused_plain if fused else attention_step_paged_plain
    k_true, v_true = (np.zeros((L, N, u, M), np.float32) for _ in range(2))
    step_fn = _jax_step(u)
    for t in range(steps):
        q, kh, vh = (rng.standard_normal((L, N, M)).astype(np.float32) for _ in range(3))
        want, jcache = step_fn(jcache, q, kh, vh, jnp.asarray(mask), t)
        for i in range(L):
            got = twin(*(torch.from_numpy(x[i]) for x in (q, kh, vh)), torch.from_numpy(mask),
                       pcache, t, i, H)
            np.testing.assert_allclose(got.numpy(), np.asarray(want[i]), atol=2e-4, rtol=0,
                                       err_msg=f"step {t} layer {i}")
        k_true[:, :, t], v_true[:, :, t] = kh, vh
        parent = rng.integers(0, K, (B, K))
        src = (np.arange(B)[:, None] * K + parent).reshape(-1)
        jcache = jax_reorder(jcache, jnp.asarray(parent, jnp.int32), t)
        pcache = beam_reorder_cache(pcache, torch.from_numpy(parent), t)
        k_true, v_true = k_true[:, src], v_true[:, src]
    last = steps - 1
    assert last % page != page - 1 and last >= page  # ends mid-page, after a completion
    for cache in (pcache, jcache):
        got_k, got_v = _logical(cache, page, last)
        np.testing.assert_array_equal(got_k, k_true[:, :, :last + 1])
        np.testing.assert_array_equal(got_v, v_true[:, :, :last + 1])


def _mid_decode_state(rng, page, fused, u, s0):
    """Seeded bf16-valued content and the table/act_src of a beam history of s0 steps."""
    cache = _zero_cache(page, fused, u)
    for key in cache:
        if cache[key].dtype == np.float32:
            cache[key] = np.asarray(jnp.asarray(rng.standard_normal(cache[key].shape), jnp.bfloat16),
                                    np.float32)
    table, src = cache["table"], cache["act_src"]
    for t in range(s0):
        src = (np.arange(B)[:, None] * K + rng.integers(0, K, (B, K))).reshape(-1).astype(np.int32)
        table = table[src]
        if t % page == page - 1:
            table[:, t // page] = src
    cache["table"], cache["act_src"] = table, src
    return cache


# name, first step: the three steps cross a page completion
BF16_CASES = [("page32_split", 30), ("page64_split", 62), ("page64_fused", 62)]


@pytest.mark.parametrize("name,s0", BF16_CASES)
def test_bf16_matches_tpu_kernel_interpret(name, s0, monkeypatch):
    page, fused, _ = CONFIGS[name]
    if page == 64:  # the JAX package takes its chunked paged kernel at page 64
        monkeypatch.setattr(ats, "max_u_whole_row", lambda m, itemsize: 8)
    u = 2 * page
    rng = np.random.default_rng(s0 + fused)
    state = _mid_decode_state(rng, page, fused, u, s0)
    jcache, pcache = _to_jax(state, jnp.bfloat16), _to_port(state, torch.bfloat16)
    mask = rng.random((N, u)) > 0.2
    mask[:, 0] = True
    for t in range(s0, s0 + 3):
        for i in range(L):
            q, kh, vh = (rng.standard_normal((N, M)).astype(np.float32) for _ in range(3))
            jargs = (jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(mask.astype(np.int8)))
            if fused:
                want, jcache["kv"], jcache["kv_act"] = ats.cached_attention_step_paged_fused(
                    *jargs, jcache["kv"], jcache["kv_act"], jcache["table"], jcache["act_src"], t,
                    i, H, interpret=True)
            else:
                (want, jcache["k"], jcache["v"], jcache["k_act"],
                 jcache["v_act"]) = ats.cached_attention_step_paged(
                    *jargs, jcache["k"], jcache["v"], jcache["k_act"], jcache["v_act"],
                    jcache["table"], jcache["act_src"], t, i, H, interpret=True)
            twin = attention_step_paged_fused_plain if fused else attention_step_paged_plain
            got = twin(torch.from_numpy(q), torch.from_numpy(kh), torch.from_numpy(vh),
                       torch.from_numpy(mask), pcache, t, i, H)
            want = np.asarray(want)
            rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert rel < 2e-2, (t, i, rel)
        parent = rng.integers(0, K, (B, K))
        jcache = jax_reorder(jcache, jnp.asarray(parent, jnp.int32), t)
        pcache = beam_reorder_cache(pcache, torch.from_numpy(parent), t)
    for got, want in zip(_logical(pcache, page, s0 + 2), _logical(jcache, page, s0 + 2)):
        np.testing.assert_array_equal(got, want)


def test_cpu_wrappers_take_the_plain_twin():
    rng = np.random.default_rng(3)
    state = _mid_decode_state(rng, 32, False, 64, 40)
    mask = torch.from_numpy(rng.random((N, 64)) > 0.2)
    q, kh, vh = (torch.from_numpy(rng.standard_normal((N, M)).astype(np.float32)) for _ in range(3))
    want_cache = _to_port(state)
    want = attention_step_paged_plain(q, kh, vh, mask, want_cache, 40, 1, H)
    counts = (port.attention_step_paged.launches, port.attention_step_paged_chunked.launches)
    for kernel in (port.attention_step_paged, port.attention_step_paged_chunked,
                   port.cached_attention_step_paged):
        cache = _to_port(state)
        assert torch.equal(kernel(q, kh, vh, mask, cache, 40, 1, H), want)
        for key in want_cache:
            assert torch.equal(cache[key], want_cache[key]), key
    assert (port.attention_step_paged.launches, port.attention_step_paged_chunked.launches) == counts


def test_twins_refuse_the_other_layout():
    q = torch.zeros(N, M)
    mask = torch.ones(N, 128, dtype=torch.bool)
    split, fused = _to_port(_zero_cache(64, False, 128)), _to_port(_zero_cache(64, True, 128))
    with pytest.raises(ValueError):
        attention_step_paged_plain(q, q, q, mask, fused, 3, 0, H)
    with pytest.raises(ValueError):
        attention_step_paged_fused_plain(q, q, q, mask, split, 3, 0, H)


@pytest.mark.parametrize("u,dtype,fused,chunked", [
    (96, torch.float32, False, False), (256, torch.float32, True, True),
    (256, torch.float32, False, True), (256, torch.bfloat16, False, False),
    (448, torch.bfloat16, False, True)])
def test_dispatch_follows_the_jax_rule(u, dtype, fused, chunked, monkeypatch):
    """K6 for the fused layout and above ``max_u_whole_row`` (213 f32, 426
    bf16 at M 768), else K5; CPU tensors, so the launch counts stay and the
    choice is read from the kernel the dispatcher called."""
    calls = []
    mask = torch.ones(8, u, dtype=torch.bool)
    cache = {"kv" if fused else "k": torch.zeros(1, 8, 2 * u if fused else u, 768, dtype=dtype)}
    monkeypatch.setattr(port, "attention_step_paged", lambda *a: calls.append("K5"))
    monkeypatch.setattr(port, "attention_step_paged_chunked", lambda *a: calls.append("K6"))
    port.cached_attention_step_paged(None, None, None, mask, cache, 0, 0, 8)
    assert calls == ["K6" if chunked else "K5"]


def _bad(cache, case):
    """A copy of ``cache`` with one operand broken as ``case`` names."""
    cache = dict(cache)
    if case == "int8":
        return {k: v.to(torch.int8) if v.is_floating_point() else v for k, v in cache.items()}
    if case == "strided_table":
        cache["table"] = cache["table"].t().contiguous().t()
    elif case == "int64_table":
        cache["table"] = cache["table"].long()
    elif case == "short_slots":
        cache["k_act"] = cache["k_act"][:, :, :1].contiguous()
    elif case == "act_src_shape":
        cache["act_src"] = cache["act_src"][:-1]
    elif case == "table_columns":
        cache["table"] = cache["table"][:, :1].repeat(1, 3).contiguous()
    return cache


@pytest.mark.parametrize("case,step,error", [
    ("int8", 3, TypeError), ("strided_table", 3, ValueError), ("int64_table", 3, ValueError),
    ("short_slots", 3, ValueError), ("act_src_shape", 3, ValueError),
    ("table_columns", 3, ValueError), ("none", -1, ValueError),
    ("none", 128, ValueError), ("none", 127, None)])
def test_kernel_operand_checks(case, step, error):
    """What the K5/K6 wrappers check before a launch (run here on CPU tensors)."""
    cache = _to_port(_zero_cache(64, False, 128))
    q = torch.zeros(N, M)
    mask = torch.ones(N, 128, dtype=torch.bool)
    if error is None:
        assert port._check(q, q, q, mask, _bad(cache, case), step, 1, H) == (128, 64, False)
        return
    with pytest.raises(error):
        port._check(q, q, q, mask, _bad(cache, case), step, 1, H)


@pytest.mark.parametrize("table_kind,nan_masked", [("identity", False), ("single", False),
                                                   ("identity", True), ("single", True)])
def test_twin_matches_jax_on_identity_and_single_owner_tables(table_kind, nan_masked):
    """The split twin against JAX's paged reference at page 32, step 75 (two
    completed pages, 11 active positions) on tables without sharing (every
    row owns its pages) and with full sharing (row 0 owns every page and
    active slot), the shapes K5 stages least and most alike. With
    ``nan_masked`` the port's cache holds NaN at the positions every row has
    masked (inside the completed owner pages) where JAX's holds finite
    values: masked positions must not reach the output."""
    page, u, step = 32, 128, 75
    rng = np.random.default_rng(11 + len(table_kind))
    state = _zero_cache(page, False, u)
    for key in ("k", "v", "k_act", "v_act"):
        state[key] = rng.standard_normal(state[key].shape).astype(np.float32)
    if table_kind == "single":
        state["table"] = np.zeros_like(state["table"])
        state["act_src"] = np.zeros_like(state["act_src"])
    mask = rng.random((N, u)) > 0.2
    mask[:, 0] = True
    masked = [5, 20, 33, 60]
    mask[:, masked] = False
    port_state = {k: v.copy() for k, v in state.items()}
    if nan_masked:
        for key in ("k", "v"):
            port_state[key][:, :, masked] = np.nan
    q, kh, vh = (rng.standard_normal((L, N, M)).astype(np.float32) for _ in range(3))
    want, _ = _jax_step(u)(_to_jax(state), q, kh, vh, jnp.asarray(mask), step)
    pcache = _to_port(port_state)
    for i in range(L):
        got = attention_step_paged_plain(*(torch.from_numpy(x[i]) for x in (q, kh, vh)),
                                         torch.from_numpy(mask), pcache, step, i, H)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want[i]), atol=2e-4, rtol=0,
                                   err_msg=f"layer {i}")


def _int8_state(rng, u, s0):
    """Seeded int8 codes and (L, N, U) scales at page 32 (split), with the
    table/act_src of a beam history of s0 steps."""
    state = _mid_decode_state(rng, PAGE32, False, u, s0)
    for key in ("k", "v", "k_act", "v_act"):
        state[key] = rng.integers(-127, 128, state[key].shape).astype(np.int8)
    for key in ("k_scale", "v_scale"):
        state[key] = rng.uniform(0.002, 0.05, (L, N, u)).astype(np.float32)
    return state


PAGE32 = 32


def test_int8_protocol_matches_jax():
    """int8 caches, page 32 (the only int8 paging in this slice): the split
    twin against ``_make_attends_paged_jnp(quant=True)`` + ``attend_cached``
    (the reference math, run eagerly: jitted, XLA turns finalize's division
    by 127 into a product) over 40 steps with a random beam reorder after
    each, crossing the page completion at step 31. Every output within 1e-5;
    at the end the logical codes and the scales equal JAX's bit for bit. The
    scales move with the reorder while the codes do not, so a reorder that
    left them behind fails here."""
    steps, u = 40, 64
    rng = np.random.default_rng(77)
    mask = rng.random((N, u)) > 0.2
    mask[:, 0] = True
    zero = _zero_cache(PAGE32, False, u, np.int8)
    zero["k_scale"], zero["v_scale"] = (np.zeros((L, N, u), np.float32) for _ in range(2))
    jcache, pcache = _to_jax(zero), _to_port(zero)
    attns = [MultiHeadAttention(M, H)] * L
    d = M // H
    for t in range(steps):
        q, kh, vh = (rng.standard_normal((L, N, M)).astype(np.float32) for _ in range(3))
        attends, finalize = _make_attends_paged_jnp(attns, jcache, jnp.asarray(mask), t, H, True)
        want = [attends[i](*(jnp.asarray(x[i]).reshape(N, 1, H, d) for x in (q, kh, vh)))
                for i in range(L)]
        jcache = {**finalize([jnp.asarray(x).reshape(N, 1, M) for x in kh],
                             [jnp.asarray(x).reshape(N, 1, M) for x in vh]),
                  "tokens": jcache["tokens"]}
        for i in range(L):
            got = attention_step_paged_plain(*(torch.from_numpy(x[i]) for x in (q, kh, vh)),
                                             torch.from_numpy(mask), pcache, t, i, H)
            np.testing.assert_allclose(got.numpy(), np.asarray(want[i]).reshape(N, M), atol=1e-5,
                                       rtol=0, err_msg=f"step {t} layer {i}")
        parent = rng.integers(0, K, (B, K))
        jcache = jax_reorder(jcache, jnp.asarray(parent, jnp.int32), t)
        pcache = beam_reorder_cache(pcache, torch.from_numpy(parent), t)
    last = steps - 1
    for got, want in zip(_logical(pcache, PAGE32, last), _logical(jcache, PAGE32, last)):
        np.testing.assert_array_equal(got, want)
    for key in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(pcache[key][:, :, :steps].numpy(),
                                      np.asarray(jcache[key])[:, :, :steps], err_msg=key)


def test_int8_matches_tpu_kernel_interpret():
    """int8, page 32: the split twin against the TPU kernel
    ``cached_attention_step_paged`` in interpret mode over steps 30-32 (a page
    completes at 31) from a seeded mid-decode state, at the kernel's own int8
    tolerance, 3e-2 relative to the largest output (it rounds q and the
    dequantized keys to bf16); q/kh/vh that bf16 represents exactly, so both
    quantize the same rows: the rebuilt codes equal the kernel's, and each
    step's scales are within one f32 ulp (the kernel's ``amax * (1 / 127)``)."""
    s0, u = 30, 64
    rng = np.random.default_rng(31)
    state = _int8_state(rng, u, s0)
    jcache, pcache = _to_jax(state), _to_port(state)
    mask = rng.random((N, u)) > 0.2
    mask[:, 0] = True
    for t in range(s0, s0 + 3):
        for i in range(L):
            q, kh, vh = (np.asarray(jnp.asarray(rng.standard_normal((N, M)), jnp.bfloat16),
                                    np.float32) for _ in range(3))
            (want, jcache["k"], jcache["v"], jcache["k_act"], jcache["v_act"], kso,
             vso) = ats.cached_attention_step_paged(
                jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(mask.astype(np.int8)),
                jcache["k"], jcache["v"], jcache["k_act"], jcache["v_act"], jcache["table"],
                jcache["act_src"], t, i, H, interpret=True, k_scale=jcache["k_scale"][i],
                v_scale=jcache["v_scale"][i])
            jcache["k_scale"] = jcache["k_scale"].at[i, :, t].set(kso[:, 0])
            jcache["v_scale"] = jcache["v_scale"].at[i, :, t].set(vso[:, 0])
            got = attention_step_paged_plain(torch.from_numpy(q), torch.from_numpy(kh),
                                             torch.from_numpy(vh), torch.from_numpy(mask), pcache,
                                             t, i, H)
            want = np.asarray(want)
            rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert rel < 3e-2, (t, i, rel)
            for key in ("k_scale", "v_scale"):
                np.testing.assert_array_max_ulp(pcache[key][i, :, t].numpy(),
                                                np.asarray(jcache[key][i, :, t]), 1)
        parent = rng.integers(0, K, (B, K))
        jcache = jax_reorder(jcache, jnp.asarray(parent, jnp.int32), t)
        pcache = beam_reorder_cache(pcache, torch.from_numpy(parent), t)
    for got, want in zip(_logical(pcache, PAGE32, s0 + 2), _logical(jcache, PAGE32, s0 + 2)):
        np.testing.assert_array_equal(got, want)


def _int8_chunked_state(rng, fused, u, s0, uniform):
    """Seeded int8 codes and (L, N, U) scales at page 64, split or fused, with
    the table/act_src of a beam history of s0 steps: ``uniform`` coalesces
    every row onto row 0 each step (one utterance of N beams, so the TPU
    kernel's 8-row tiles share their owners: its uniform-page path), else
    random parents within utterances of K beams."""
    state = _zero_cache(64, fused, u, np.int8)
    for key in ("k", "v", "k_act", "v_act", "kv", "kv_act"):
        if key in state:
            state[key] = rng.integers(-127, 128, state[key].shape).astype(np.int8)
    for key in ("k_scale", "v_scale"):
        state[key] = rng.uniform(0.002, 0.05, (L, N, u)).astype(np.float32)
    table, src = state["table"], state["act_src"]
    for t in range(s0):
        src = (np.zeros(N) if uniform else
               (np.arange(B)[:, None] * K + rng.integers(0, K, (B, K))).reshape(-1)).astype(np.int32)
        table = table[src]
        if t % 64 == 63:
            table[:, t // 64] = src
    state["table"], state["act_src"] = table, src
    return state


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("history", ["uniform", "mixed"])
def test_int8_chunked_matches_tpu_kernel_interpret(fused, history, monkeypatch):
    """int8, page 64 (K6's int8 mode), fused and split: the twin against the
    TPU kernel ``_kernel_chunked_paged`` in interpret mode over steps 62-64
    (a page completes at 63), at layer 1 (each layer is a compile of the
    interpreted kernel), from a seeded mid-decode state whose table is
    uniform (every row owns the same pages: the kernel's path that factors
    the K scale out of the dot) or mixed, at the kernel's own int8
    tolerance, 3e-2 relative to the largest output (it rounds q and the
    dequantized keys to bf16); q/kh/vh that bf16 represents exactly, so both
    quantize the same rows: each step's scales within one f32 ulp (the
    kernel's ``amax * (1 / 127)``), and after the steps the rebuilt logical
    codes (merged pages and slots included) equal the kernel's."""
    monkeypatch.setattr(ats, "max_u_whole_row", lambda m, itemsize: 8)
    s0, u = 62, 128
    rng = np.random.default_rng(62 + fused + 2 * (history == "uniform"))
    state = _int8_chunked_state(rng, fused, u, s0, history == "uniform")
    jcache, pcache = _to_jax(state), _to_port(state)
    mask = rng.random((N, u)) > 0.2
    mask[:, 0] = True
    twin = attention_step_paged_fused_plain if fused else attention_step_paged_plain
    for t in range(s0, s0 + 3):
        for i in (1,):
            q, kh, vh = (np.asarray(jnp.asarray(rng.standard_normal((N, M)), jnp.bfloat16),
                                    np.float32) for _ in range(3))
            jargs = (jnp.asarray(q), jnp.asarray(kh), jnp.asarray(vh),
                     jnp.asarray(mask.astype(np.int8)))
            scales = dict(k_scale=jcache["k_scale"][i], v_scale=jcache["v_scale"][i])
            if fused:
                want, jcache["kv"], jcache["kv_act"], kso, vso = ats.cached_attention_step_paged_fused(
                    *jargs, jcache["kv"], jcache["kv_act"], jcache["table"], jcache["act_src"], t,
                    i, H, interpret=True, **scales)
            else:
                (want, jcache["k"], jcache["v"], jcache["k_act"], jcache["v_act"], kso,
                 vso) = ats.cached_attention_step_paged(
                    *jargs, jcache["k"], jcache["v"], jcache["k_act"], jcache["v_act"],
                    jcache["table"], jcache["act_src"], t, i, H, interpret=True, **scales)
            jcache["k_scale"] = jcache["k_scale"].at[i, :, t].set(kso[:, 0])
            jcache["v_scale"] = jcache["v_scale"].at[i, :, t].set(vso[:, 0])
            got = twin(torch.from_numpy(q), torch.from_numpy(kh), torch.from_numpy(vh),
                       torch.from_numpy(mask), pcache, t, i, H)
            want = np.asarray(want)
            rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert rel < 3e-2, (t, i, rel)
            for key in ("k_scale", "v_scale"):
                np.testing.assert_array_max_ulp(pcache[key][i, :, t].numpy(),
                                                np.asarray(jcache[key][i, :, t]), 1)
        parent = np.zeros((1, N), int) if history == "uniform" else rng.integers(0, K, (B, K))
        jcache = jax_reorder(jcache, jnp.asarray(parent, jnp.int32), t)
        pcache = beam_reorder_cache(pcache, torch.from_numpy(parent), t)
    for got, want in zip(_logical(pcache, 64, s0 + 2), _logical(jcache, 64, s0 + 2)):
        np.testing.assert_array_equal(got, want)


def test_int8_chunked_kernel_refuses():
    """K6 on int8 CPU tensors, page 64, fused and split: the wrapper and the
    dispatcher run the twin (output, codes and scales alike; no launch
    counted); int8 codes without their scales are refused."""
    rng = np.random.default_rng(5)
    q, kh, vh = (torch.from_numpy(rng.standard_normal((N, M)).astype(np.float32))
                 for _ in range(3))
    mask = torch.from_numpy(rng.random((N, 128)) > 0.2)
    launches = port.attention_step_paged_chunked.launches
    for fused in (True, False):
        state = _int8_chunked_state(rng, fused, 128, 70, False)
        twin = attention_step_paged_fused_plain if fused else attention_step_paged_plain
        want_cache = _to_port(state)
        want = twin(q, kh, vh, mask, want_cache, 70, 1, H)
        for kernel in (port.attention_step_paged_chunked, port.cached_attention_step_paged):
            cache = _to_port(state)
            assert torch.equal(kernel(q, kh, vh, mask, cache, 70, 1, H), want)
            for key in want_cache:
                assert torch.equal(cache[key], want_cache[key]), key
        unscaled = {k: v for k, v in _to_port(state).items() if "scale" not in k}
        with pytest.raises(TypeError, match="k_scale"):
            port._check(q, kh, vh, mask, unscaled, 70, 1, H)
    assert port.attention_step_paged_chunked.launches == launches


@pytest.mark.parametrize("dtype,chunked", [(torch.int8, False), (torch.float32, False),
                                           (torch.bfloat16, False), (torch.int8, True)])
def test_k5_launch_takes_the_layout_rule(monkeypatch, dtype, chunked):
    """The paged launch hands the C entry the cache's layers and, for int8
    K5 only, K3's ``whole_row_layout`` ring (which the kernel refuses unless
    its own layout agrees); f32/bf16 K5 and K6 get none."""
    rng = np.random.default_rng(8)
    state = _int8_state(rng, 96, 40) if dtype == torch.int8 else _zero_cache(PAGE32, False, 96)
    cache = {k: torch.from_numpy(v) if v.dtype != np.float32 or k.endswith("scale")
             else torch.from_numpy(v).to(dtype) for k, v in state.items()}
    q = torch.zeros(N, M)
    mask = torch.ones(N, 96, dtype=torch.bool)
    calls = []
    monkeypatch.setattr(port, "_entry", lambda: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0}))
    port._launch(chunked, q, q, q, mask, cache, 40, 1, H)
    ring = (0, 0, 0)
    if dtype == torch.int8 and not chunked:
        ring = port.whole_row_layout(40, M // H, 1)
    code = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[dtype]
    assert calls[0][13:-2] == (L, N, 96, M, H, 40, 1, PAGE32, 0, code, int(chunked), *ring)

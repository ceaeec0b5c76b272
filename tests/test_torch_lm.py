"""The port's ``TransformerLM`` against the JAX package's (CPU).

* ``lm_state_dict``: every flax leaf comes back bit for bit from the port's
  state_dict (both heads);
* ``forward``: logits within atol 1e-4, both heads, with pad tokens;
* ``decode_step`` on a physical cache: 12 steps against JAX's
  ``decode_step`` and against the full forward's last position, atol 1e-4;
* ``decode_step`` per layer on paged caches (split page 32; fused page 64, the
  layout K7 takes, built by hand at a small width as the JAX package's own
  megastep test does): against JAX's ``decode_step``, which runs
  ``_make_attends_paged_jnp`` off its accelerator, with a random beam
  reorder after every step and across page completions, atol 1e-4;
* the K7 gate: with stacked weights, a fused cache on the CPU still takes
  the per-layer path (the kernel branch is for caches on the card).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.transformer import TransformerLM as JaxLM
from speech_anonymization_tpu.models.transformer import beam_reorder_cache as jax_reorder
from speech_anonymization_tpu.models.transformer import make_kv_cache as jax_make_cache
from speech_anonymization_tpu_torch.models import TransformerLM
from speech_anonymization_tpu_torch.models.transformer import beam_reorder_cache, make_kv_cache
from speech_anonymization_tpu_torch.utils.convert import lm_state_dict, load_numpy_state
from tests.torch_port_helpers import perturbed, t

WIDTHS = dict(vocab=40, d_model=128, nhead=4, num_layers=2, d_ffn=256, max_len=200)
B, K = 2, 4
N = B * K
# port name of each flax submodule in an LM's tree
_NAMES = {"attn": "attn", "LayerNorm_0": "ln1", "LayerNorm_1": "ln2", "FeedForward_0": "ff",
          "Dense_0": "dense0", "Dense_1": "dense1", "kernel": "weight", "scale": "weight"}


@functools.lru_cache(maxsize=None)
def _models(sb_compat: bool):
    jl = JaxLM(**WIDTHS, sb_compat=sb_compat)
    v = perturbed(jax.jit(jl.init)(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32)), 3)
    pl = load_numpy_state(TransformerLM(**WIDTHS, sb_compat=sb_compat, device="cpu"),
                          lm_state_dict(v)).eval()
    return jl, v, pl


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@pytest.mark.parametrize("sb_compat", [False, True])
def test_lm_state_dict_round_trip(sb_compat):
    _, v, pl = _models(sb_compat)
    state = pl.state_dict()
    n = 0
    for path, want in _leaves(v["params"]):
        if path[0] == "embed":
            got = state["embed.weight"].numpy()
        else:
            names = [f"layers.{p[6:]}" if p.startswith("layer_") else _NAMES.get(p, p) for p in path]
            got = state[".".join(names)].numpy()
            if path[-1] == "kernel":
                got = got.T
        np.testing.assert_array_equal(got.reshape(want.shape), want, err_msg=str(path))
        n += 1
    assert n == len(state)  # every port tensor is some flax leaf


def _tokens(rng, shape):
    toks = rng.integers(3, WIDTHS["vocab"], shape)
    toks[rng.random(shape) < 0.15] = 0  # pad keys are masked
    toks[:, 0] = 1
    return toks.astype(np.int32)


@pytest.mark.parametrize("sb_compat", [False, True])
def test_forward_matches_jax(sb_compat):
    jl, v, pl = _models(sb_compat)
    toks = _tokens(np.random.default_rng(0), (3, 12))
    want = jax.jit(jl.apply)(v, jnp.asarray(toks))
    with torch.no_grad():
        got = pl(t(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_step(sb_compat: bool):
    jl, _, _ = _models(sb_compat)
    return jax.jit(lambda v, tok, cache, step: jl.apply(v, tok, cache, step,
                                                        method=JaxLM.decode_step))


@pytest.mark.parametrize("sb_compat", [False, True])
def test_decode_step_physical_matches_jax_and_forward(sb_compat):
    jl, v, pl = _models(sb_compat)
    steps = 12
    toks = _tokens(np.random.default_rng(1), (N, steps))
    with torch.no_grad():
        full = pl(t(toks).long())
    jcache = jax_make_cache(N, steps, WIDTHS["num_layers"], WIDTHS["nhead"],
                            WIDTHS["d_model"] // WIDTHS["nhead"])
    pcache = pl.init_cache(N, steps)
    assert "table" not in pcache and pcache["k"].shape == jcache["k"].shape
    step_fn = _jax_step(sb_compat)
    for s in range(steps):
        want, jcache = step_fn(v, jnp.asarray(toks[:, s]), jcache, jnp.int32(s))
        with torch.no_grad():
            got, pcache = pl.decode_step(t(toks[:, s]).long(), pcache, s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0,
                                   err_msg=f"step {s}")
        np.testing.assert_allclose(got.numpy(), full[:, s].numpy(), atol=1e-4, rtol=0,
                                   err_msg=f"step {s} vs forward")


def _fused_cache(u, page=64):
    """The fused page-64 layout at this width (make_kv_cache emits it only for
    U above ``max_u_whole_row``, thousands of positions at d_model 128)."""
    layers, m = WIDTHS["num_layers"], WIDTHS["d_model"]
    return {"kv": np.zeros((layers, N, 2 * u, m), np.float32),
            "kv_act": np.zeros((layers, N, 2, 2 * page, m), np.float32),
            "tokens": np.zeros((N, u), np.int32),
            "table": np.repeat(np.arange(N, dtype=np.int32)[:, None], u // page, axis=1),
            "act_src": np.arange(N, dtype=np.int32)}


# name: (decode steps, the cache as numpy); page 32 completes at 31, page 64 at 63
PAGED = {"page32_split": (40, lambda: {k: np.asarray(x) for k, x in jax_make_cache(
             N, 41, WIDTHS["num_layers"], WIDTHS["nhead"], WIDTHS["d_model"] // WIDTHS["nhead"],
             paged=True).items()}),
         "page64_fused": (70, lambda: _fused_cache(128))}


@pytest.mark.parametrize("name", list(PAGED))
def test_paged_per_layer_decode_matches_jax(name):
    jl, v, pl = _models(False)
    steps, make = PAGED[name]
    state = make()
    assert ("kv" in state) == (name == "page64_fused") and "table" in state
    jcache = {k: jnp.asarray(x) for k, x in state.items()}
    pcache = {k: t(x).long() if k == "tokens" else t(x) for k, x in state.items()}
    port_layout = make_kv_cache(N, steps + 1, WIDTHS["num_layers"], WIDTHS["nhead"],
                                WIDTHS["d_model"] // WIDTHS["nhead"], device="cpu", paged=True)
    if name == "page32_split":  # the port builds the same layout
        assert {k: tuple(x.shape) for k, x in port_layout.items()} == {
            k: x.shape for k, x in state.items()}
    rng = np.random.default_rng(len(name))
    step_fn = _jax_step(False)
    reorder = jax.jit(jax_reorder)
    for s in range(steps):
        tok = rng.integers(0, WIDTHS["vocab"], N).astype(np.int32)
        want, jcache = step_fn(v, jnp.asarray(tok), jcache, jnp.int32(s))
        with torch.no_grad():
            got, pcache = pl.decode_step(t(tok).long(), pcache, s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0,
                                   err_msg=f"step {s}")
        parent = rng.integers(0, K, (B, K))
        jcache = reorder(jcache, jnp.asarray(parent, jnp.int32), jnp.int32(s))
        pcache = beam_reorder_cache(pcache, torch.from_numpy(parent), s)
    np.testing.assert_array_equal(pcache["table"].numpy(), np.asarray(jcache["table"]))


def test_megastep_gate_takes_per_layer_path_on_cpu():
    _, _, pl = _models(False)
    mega = pl.prepare_megastep()
    tok = torch.full((N,), 7)
    caches = [{k: t(x).long() if k == "tokens" else t(x) for k, x in _fused_cache(128).items()}
              for _ in range(2)]
    with torch.no_grad():
        with_mega, _ = pl.decode_step(tok, caches[0], 0, mega)
        without, _ = pl.decode_step(tok, caches[1], 0)
    assert torch.equal(with_mega, without)
    for key in caches[0]:
        assert torch.equal(caches[0][key], caches[1][key]), key

"""The port's paged decode cache against the JAX package's (CPU): layout,
the beam reorder's table gather, and the rule that chooses paging.

* ``make_kv_cache(paged=True)``: keys, shapes, dtypes, ``table``, ``act_src``
  and ``tokens`` for f32/bf16 x (short split, long fused, long split); the
  long regime at d_model 768, where U > ``max_u_whole_row``;
* ``beam_reorder_cache``'s paged branch: ``table``, ``act_src`` and
  ``tokens`` equal JAX's exactly through a run of random reorders that
  crosses page completions;
* ``use_paged_cache`` and ``ASRBundle.pages``: the JAX rule, read on the
  cache's device (paging on the card, never on the CPU), and
  ``decode_paged_kv: false``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.transformer import beam_reorder_cache as jax_reorder
from speech_anonymization_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from speech_anonymization_tpu_torch.models import ASRModel
from speech_anonymization_tpu_torch.models.transformer import (
    beam_reorder_cache,
    make_kv_cache,
    use_paged_cache,
)
from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# name: (N, u_max, L, H, d_head, fused); long caches at M 768: U > 213 (f32), > 426 (bf16)
REGIMES = {"short_split": (8, 41, 2, 4, 64, True), "long_fused": (8, 430, 1, 8, 96, True),
           "long_split": (8, 430, 1, 8, 96, False)}


def _jax_cache(regime, dtype, monkeypatch):
    n, u_max, layers, nhead, d_head, fused = REGIMES[regime]
    monkeypatch.setenv("SATPU_FUSED_KV", "1" if fused else "0")
    return jax_make_kv_cache(n, u_max, layers, nhead, d_head, dtype=_DTYPES[dtype][0], paged=True)


def _port_cache(regime, dtype):
    n, u_max, layers, nhead, d_head, fused = REGIMES[regime]
    return make_kv_cache(n, u_max, layers, nhead, d_head, _DTYPES[dtype][1], device="cpu",
                         paged=True, fused=fused)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime", list(REGIMES))
def test_layout_matches_jax(regime, dtype, monkeypatch):
    want = _jax_cache(regime, dtype, monkeypatch)
    got = _port_cache(regime, dtype)
    assert sorted(got) == sorted(want)
    assert ("kv" in got) == (regime == "long_fused")
    for key, value in want.items():
        assert tuple(got[key].shape) == value.shape, key
        if key in ("table", "act_src"):
            assert got[key].dtype == torch.int32 and got[key].is_contiguous()
            assert got[key].stride() == torch.empty(value.shape).stride()  # no zero row stride
        elif key != "tokens":
            assert got[key].dtype == _DTYPES[dtype][1], key
        np.testing.assert_array_equal(got[key].float().numpy(), np.asarray(value, np.float32))


def test_paged_cache_has_no_spare_pair():
    assert not {"k_spare", "v_spare"} & set(_port_cache("short_split", "float32"))
    assert {"k_spare", "v_spare"} <= set(make_kv_cache(8, 41, 2, 4, 64, device="cpu"))


@pytest.mark.parametrize("regime", ["short_split", "long_fused"])
def test_reorder_matches_jax(regime, monkeypatch):
    """Random reorders after every step through steps 0..70: page 32 completes
    at steps 31 and 63, page 64 at step 63; each step is compared."""
    rng = np.random.default_rng(len(regime))
    want = _jax_cache(regime, "float32", monkeypatch)
    got = _port_cache(regime, "float32")
    n, u = got["tokens"].shape
    beams = 4
    tokens = rng.integers(0, 24, (n, u))
    want["tokens"], got["tokens"] = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)
    page = u // got["table"].shape[1]
    completions = 0
    for step in range(71):
        parent = rng.integers(0, beams, (n // beams, beams))
        want = jax_reorder(want, jnp.asarray(parent, jnp.int32), step)
        got = beam_reorder_cache(got, torch.from_numpy(parent), step)
        completions += step % page == page - 1
        for key in ("table", "act_src", "tokens"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        assert got["table"].dtype == torch.int32 and got["act_src"].dtype == torch.int32
    assert completions == (2 if page == 32 else 1)
    assert len(np.unique(got["table"].numpy())) > 1


def test_reorder_moves_no_cache_bytes():
    cache = _port_cache("short_split", "float32")
    out = beam_reorder_cache(cache, torch.zeros(2, 4, dtype=torch.long), 31)
    for key in ("k", "v", "k_act", "v_act"):
        assert out[key] is cache[key]
    with pytest.raises(ValueError):
        beam_reorder_cache(cache, torch.zeros(2, 4, dtype=torch.long))


@pytest.mark.parametrize("n,u_max,d_model,device,paged", [
    (528, 65, 768, "cuda", True),     # D1
    (528, 253, 768, "cuda", True),    # D2
    (528, 65, 768, "cpu", False),     # never on the CPU
    (528, 65, 768, "meta", False),
    (527, 65, 768, "cuda", False),    # N % 8
    (528, 65, 96, "cuda", False),     # d_model % 128
    (528, 16385, 768, "cuda", False),  # beyond max_u_for_kernel
])
def test_use_paged_cache_rule(n, u_max, d_model, device, paged):
    assert use_paged_cache(n, u_max, d_model, torch.float32, device) is paged


def test_bundle_pages_on_the_card_only():
    model = ASRModel(d_model=128, nhead=4, num_encoder_layers=1, num_decoder_layers=1, d_ffn=32,
                     output_neurons=16, device="cpu")
    bundle = ASRBundle(model, None, {"test_beam_size": 66})
    assert bundle.pages(528, 65, torch.device("cuda")) and bundle.pages(528, 253, "cuda")
    assert not bundle.pages(528, 65, "cpu")
    assert "table" not in bundle.make_cache(16, 65, "cpu")
    opted_out = ASRBundle(model, None, {"test_beam_size": 66, "decode_paged_kv": False})
    assert not opted_out.pages(528, 65, "cuda")


@pytest.mark.parametrize("u_max,dtype,u,page,fused", [
    (65, torch.float32, 96, 32, False),     # D1: K5, table (528, 3)
    (253, torch.float32, 256, 64, True),    # D2: K6 on the fused layout, table (528, 4)
    (253, torch.bfloat16, 256, 32, False),  # D2 with bf16 caches: K5, table (528, 8)
])
def test_decode_shapes_layout(u_max, dtype, u, page, fused):
    """The full-width decode caches, built on the meta device (no memory)."""
    cache = make_kv_cache(528, u_max, 6, 8, 96, dtype, device="meta", paged=True)
    assert tuple(cache["tokens"].shape) == (528, u) and tuple(cache["table"].shape) == (528, u // page)
    if fused:
        assert tuple(cache["kv"].shape) == (6, 528, 2 * u, 768)
        assert tuple(cache["kv_act"].shape) == (6, 528, 2, 2 * page, 768)
    else:
        assert tuple(cache["k"].shape) == (6, 528, u, 768)
        assert tuple(cache["k_act"].shape) == (6, 528, 2, page, 768)

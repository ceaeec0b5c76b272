"""K2's plain twin, ``beam_gather_plain``, and the port's cache helpers against
the JAX package (CPU): the gather equals ``beam_gather_rows`` (the TPU kernel
in interpret mode) exactly on positions <= step (K2a) and on whole rows (K2b),
``beam_reorder_cache`` equals JAX's, and ``make_kv_cache`` rounds U as JAX does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.transformer import beam_reorder_cache as jax_reorder
from speech_anonymization_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from speech_anonymization_tpu.ops.pallas.beam_gather import beam_gather_rows
from speech_anonymization_tpu_torch.models.transformer import beam_reorder_cache, make_kv_cache
from speech_anonymization_tpu_torch.ops.beam_gather import (
    beam_gather,
    beam_gather_faults,
    beam_gather_plain,
)
from tests.torch_port_helpers import t


def _as_f32(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 5, 15, None])
def test_plain_twin_matches_tpu_kernel(dtype, step):
    """step None is K2b (whole rows); otherwise K2a (positions <= step)."""
    rng = np.random.default_rng(0 if step is None else step)
    a = jnp.asarray(rng.standard_normal((3, 12, 16, 128)).astype(np.float32)).astype(dtype)
    src = rng.integers(0, 12, size=(12,)).astype(np.int32)  # duplicate parents included
    want = _as_f32(beam_gather_rows(a, jnp.asarray(src), step, interpret=True))
    pa = t(_as_f32(a)).to(getattr(torch, dtype))
    out = torch.full_like(pa, float("nan"))
    got = beam_gather(pa, t(src), step, out)
    assert got is out and beam_gather.launches == 0  # CPU tensors take the plain twin
    p = 16 if step is None else step + 1
    np.testing.assert_array_equal(_as_f32(got)[:, :, :p], want[:, :, :p])
    assert got[:, :, p:].isnan().all()  # positions after the step are left as they were


@pytest.mark.parametrize("step", [2, None])
def test_beam_reorder_cache_matches_jax(step):
    b, k, layers = 2, 3, 2
    rng = np.random.default_rng(4)
    jc = jax_make_kv_cache(b * k, 4, layers, nhead=2, d_head=64)
    jc["k"], jc["v"] = (jnp.asarray(rng.standard_normal(jc["k"].shape).astype(np.float32))
                        for _ in range(2))
    jc["tokens"] = jnp.asarray(rng.integers(0, 9, jc["tokens"].shape).astype(np.int32))
    pc = make_kv_cache(b * k, 4, layers, nhead=2, d_head=64, device="cpu")
    for key in ("k", "v", "tokens"):
        pc[key].copy_(t(np.asarray(jc[key])))
    parent = np.array([[2, 0, 0], [1, 2, 0]])
    want = jax_reorder(jc, jnp.asarray(parent, jnp.int32), step)
    old_k, old_v = pc["k"], pc["v"]
    got = beam_reorder_cache(pc, t(parent), step)
    p = 8 if step is None else step + 1
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key][:, :, :p].numpy(), np.asarray(want[key])[:, :, :p])
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    # the gather wrote into the spare buffers; the old ones are the next spares
    assert got["k_spare"] is old_k and got["v_spare"] is old_v
    assert got["k"].data_ptr() != old_k.data_ptr()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("u_max", [1, 6, 65, 213, 214, 253, 426, 427])
def test_make_kv_cache_rounds_u_like_jax(dtype, u_max):
    """U: a multiple of 8, and of 64 above max_u_whole_row (213 f32 / 426 bf16 at M 768)."""
    want = jax_make_kv_cache(4, u_max, 2, 8, 96, dtype=getattr(jnp, dtype))
    got = make_kv_cache(4, u_max, 2, 8, 96, dtype=getattr(torch, dtype), device="cpu")
    for key in ("k", "v", "tokens"):
        assert tuple(got[key].shape) == want[key].shape, key
    assert got["k_spare"].shape == got["k"].shape and got["v_spare"].dtype == got["v"].dtype
    assert not got["k"].any() and (got["tokens"] == 0).all()


def test_refuses_int8_caches():
    """A physical int8 cache above the whole-row bound (u_max 449: U 512, the
    30 s shape's) reorders like JAX's: K2's twin gathers the codes at
    positions <= step, the scales move whole along N, into the spare pair."""
    b, k, step = 2, 4, 300
    rng = np.random.default_rng(11)
    jc = jax_make_kv_cache(b * k, 449, 2, 8, 96, dtype=jnp.int8)
    pc = make_kv_cache(b * k, 449, 2, 8, 96, dtype=torch.int8, device="cpu")
    assert pc["k"].shape == (2, b * k, 512, 768) and pc["k_scale"].shape == (2, b * k, 512)
    for key in ("k", "v", "k_scale", "v_scale"):
        values = (rng.integers(-128, 128, jc[key].shape).astype(np.int8) if key in ("k", "v")
                  else rng.uniform(1e-3, 0.05, jc[key].shape).astype(np.float32))
        jc[key] = jnp.asarray(values)
        pc[key].copy_(t(values))
    parent = np.array([[3, 3, 0, 1], [2, 0, 0, 3]])
    want = jax_reorder(jc, jnp.asarray(parent, jnp.int32), step)
    spare = pc["k_spare"]
    got = beam_reorder_cache(pc, t(parent), step)
    assert got["k"] is spare and beam_gather.launches == 0
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key][:, :, :step + 1].numpy(),
                                      np.asarray(want[key])[:, :, :step + 1])
    for key in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("step", [0, 5, 15, None])
def test_plain_twin_matches_tpu_kernel_int8(step):
    """int8 codes move as bytes, exactly, through K2's twin and the TPU kernel
    (interpret mode), every code value -128..127 included."""
    rng = np.random.default_rng(20 if step is None else 20 + step)
    codes = rng.integers(-128, 128, size=(3, 12, 16, 128)).astype(np.int8)
    src = rng.integers(0, 12, size=(12,)).astype(np.int32)
    want = np.asarray(beam_gather_rows(jnp.asarray(codes), jnp.asarray(src), step, interpret=True))
    out = torch.full(codes.shape, 99, dtype=torch.int8)
    got = beam_gather(t(codes), t(src), step, out)
    assert got is out and beam_gather.launches == 0
    p = 16 if step is None else step + 1
    np.testing.assert_array_equal(got[:, :, :p].numpy(), want[:, :, :p])
    assert (got[:, :, p:] == 99).all()


def test_plain_twin_copies_only_the_live_positions():
    a = torch.arange(2 * 3 * 8 * 4, dtype=torch.float32).view(2, 3, 8, 4)
    out = torch.zeros_like(a)
    beam_gather_plain(a, torch.tensor([2, 2, 0], dtype=torch.int32), 3, out)
    assert torch.equal(out[:, :, :4], a[:, [2, 2, 0], :4]) and not out[:, :, 4:].any()


@pytest.mark.parametrize("bad", [-4, 3])
def test_plain_twin_raises_on_out_of_range_parent(bad):
    """CPU tensors raise where the kernel counts the row in ``beam_gather_faults``."""
    a = torch.zeros(2, 3, 8, 4)
    with pytest.raises((IndexError, RuntimeError)):
        beam_gather(a, torch.tensor([0, bad, 1], dtype=torch.int32), 3, torch.zeros_like(a))
    assert beam_gather_faults("cpu") == 0

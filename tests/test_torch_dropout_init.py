"""Fresh transformer models and train-mode dropout, the port against flax (CPU):

  * the initialisation repair: a fresh ``ASRModel`` and ``TransformerLM``
    given a generator have flax's initialiser statistics on the same shapes:
    every kernel's and embedding's std within INIT_STD_RTOL of a flax init's
    (the embeddings an untruncated normal of std 1/sqrt(features); torch's
    ``nn.Embedding`` draws std 1, 27.7x flax's at 768 wide), biases and
    LayerNorm shifts 0, scales 1; the same seed gives the same weights;
  * dropout at p 0.1 in train mode (the attention weights after the softmax,
    the feed-forward's hidden activation): the port's ``TransformerLM`` and
    ``ASRModel`` fed the masks flax drew give flax's outputs and parameter
    gradients; ``train=False`` equals p 0; the port's own draws keep 0.9 of
    the elements (within 3 sigma).

The JAX package's ``MultiHeadAttention`` builds its ``nn.Dropout`` inside a
method that is neither ``setup`` nor ``@compact``, so flax refuses any
train-mode call at dropout > 0 (``test_jax_attention_dropout_is_refused``:
the JAX LM recipe can train only at ``lm_dropout`` 0). The reference here is
that module with its dropout declared in ``setup`` (a test-side subclass,
patched in for the test), which flax runs; the masks are captured with
``flax.linen.intercept_methods`` around ``nn.Dropout.__call__``, which draws
them from the module's own ``dropout`` stream.

Tolerances: init stds rtol 5e-2 (sampling: each tensor holds >= 1,152
elements); outputs atol 1e-5; gradients 1e-5 of each tensor's largest
element, plus 1e-6 of the largest gradient anywhere (the key biases'
gradients are rounding noise about 0).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models import transformer as jax_tr
from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu_torch.models.asr import ASRModel
from speech_anonymization_tpu_torch.models.transformer import DropoutRng, TransformerLM
from speech_anonymization_tpu_torch.utils.convert import asr_state_dict, asr_variables, lm_state_dict, lm_variables
from tests.torch_port_helpers import t, to_numpy

INIT_STD_RTOL = 5e-2
OUT_ATOL = 1e-5
GRAD_RTOL = 1e-5
GRAD_FLOOR = 1e-6  # of the largest gradient anywhere
RATE = 0.1
WIDE_ASR = dict(d_model=256, nhead=4, num_encoder_layers=2, num_decoder_layers=1, d_ffn=1024,
                output_neurons=512)
WIDE_LM = dict(vocab=512, d_model=256, nhead=4, num_layers=2, d_ffn=1024)
SMALL_ASR = dict(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=1, d_ffn=64, output_neurons=64)
SMALL_LM = dict(vocab=64, d_model=32, nhead=4, num_layers=2, d_ffn=64)


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _asr_inputs(b=2, t_frames=24, u=6, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t_frames, 80)).astype(np.float32)
    tokens = rng.integers(3, 60, (b, u)).astype(np.int32)
    tokens[1, 4:] = 0
    return feats, tokens, np.array([1.0, 0.75], np.float32)


def _lm_tokens(b=3, u=7, seed=1):
    tokens = np.random.default_rng(seed).integers(3, 60, (b, u)).astype(np.int32)
    tokens[:, 0] = 1
    tokens[2, 5:] = 0
    return tokens


# -- the initialisation repair ------------------------------------------------------


def _check_init(port: dict, flax: dict) -> None:
    assert set(port) == set(flax)
    for k, w in flax.items():
        p = port[k]
        if k.endswith("bias"):
            assert not p.any(), k  # biases and LayerNorm shifts: exactly 0
        elif ".ln" in k or ".norms." in k:
            assert (p == 1).all(), k  # LayerNorm scales: exactly 1
        else:
            assert w.size >= 1152, k
            np.testing.assert_allclose(p.std(), w.std(), rtol=INIT_STD_RTOL, err_msg=k)


def test_fresh_asr_model_takes_flax_initialisers():
    port = ASRModel(**WIDE_ASR, generator=_gen(0), device="cpu")
    feats, tokens, lens = _asr_inputs()
    flax_vars = jax.jit(JaxASRModel(**WIDE_ASR).init)(jax.random.PRNGKey(0), feats, tokens, lens)
    want = asr_state_dict(to_numpy(flax_vars))
    _check_init({k: v.detach().numpy() for k, v in port.state_dict().items()}, want)
    emb = port.transformer.embed.weight
    np.testing.assert_allclose(float(emb.detach().std()), 1 / np.sqrt(256), rtol=INIT_STD_RTOL)
    again = ASRModel(**WIDE_ASR, generator=_gen(0), device="cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


def test_fresh_lm_takes_flax_initialisers():
    port = TransformerLM(**WIDE_LM, generator=_gen(1), device="cpu")
    flax_vars = jax.jit(jax_tr.TransformerLM(**WIDE_LM).init)(jax.random.PRNGKey(1), _lm_tokens())
    _check_init({k: v.detach().numpy() for k, v in port.state_dict().items()}, lm_state_dict(to_numpy(flax_vars)))
    again = TransformerLM(**WIDE_LM, generator=_gen(1), device="cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
    # without a generator the weights are torch's (a checkpoint is loaded over them)
    assert float(TransformerLM(**WIDE_LM, device="cpu").embed.weight.detach().std()) > 0.9


# -- dropout ----------------------------------------------------------------------


class _SetupDropoutMHA(jax_tr.MultiHeadAttention):
    """The JAX package's attention with its dropout declared in ``setup``."""

    def setup(self):
        super().setup()
        self.weights_dropout = nn.Dropout(self.dropout)

    def __call__(self, q, kv, mask=None, train: bool = False):
        d_head = self.d_model // self.nhead
        qh, kh, vh = self.q_proj(q), self.k_proj(kv), self.v_proj(kv)
        scores = jnp.einsum("bqhd,bkhd->bhqk", qh, kh) / np.sqrt(d_head)
        if mask is not None:
            scores = jnp.where(mask, scores, jax_tr.NEG_INF)
        weights = jax.nn.softmax(scores, axis=-1)
        if self.dropout > 0 and train:
            weights = self.weights_dropout(weights, deterministic=not train)
        return self.out_proj(jnp.einsum("bhqk,bkhd->bqhd", weights, vh))


@pytest.fixture
def flax_dropout(monkeypatch):
    monkeypatch.setattr(jax_tr, "MultiHeadAttention", _SetupDropoutMHA)


def _capture(masks: list):
    """An interceptor that records each train-mode ``nn.Dropout`` call's keep
    mask: the rng the module would draw, passed on to it, so flax draws the
    same mask."""

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == "__call__" and mod.rate > 0 and not (
                kwargs.get("deterministic", mod.deterministic)):
            rng = mod.make_rng(mod.rng_collection)
            masks.append(jax.random.bernoulli(rng, 1.0 - mod.rate, args[0].shape))
            return next_fun(*args, **{**kwargs, "rng": rng})
        return next_fun(*args, **kwargs)

    return interceptor


def _flax_train(model, variables, inputs, weights, key):
    """-> (outputs, d sum(outputs . weights) / d params, the masks flax drew)."""

    def loss(params):
        masks = []
        with nn.intercept_methods(_capture(masks)):
            out = model.apply({"params": params}, *inputs, train=True, rngs={"dropout": key})
        first = out[-1] if isinstance(out, tuple) else out
        return jnp.sum(first * weights), (out, masks)

    (_, (out, masks)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return out, grads, [np.asarray(m) for m in masks]


def _check_grads(port_model, want: dict) -> None:
    # the key biases' gradients are 0 in exact arithmetic (a shift of every
    # score of a query): rounding noise, held to the floor
    floor = GRAD_FLOOR * max(float(np.abs(w).max()) for w in want.values())
    for k, p in port_model.named_parameters():
        got = np.zeros_like(want[k]) if p.grad is None else p.grad.numpy()  # the CTC head: no path
        gap = float(np.abs(got - want[k]).max())
        assert gap <= GRAD_RTOL * float(np.abs(want[k]).max()) + floor, (k, gap)


def test_lm_dropout_on_flax_masks(flax_dropout):
    port = TransformerLM(**SMALL_LM, dropout=RATE, generator=_gen(2), device="cpu")
    variables = {"params": jax.tree_util.tree_map(np.array, to_numpy(lm_variables(port)["params"]))}
    tokens = _lm_tokens()
    weights = np.random.default_rng(3).standard_normal((*tokens.shape, SMALL_LM["vocab"])).astype(np.float32)
    out, grads, masks = _flax_train(jax_tr.TransformerLM(**SMALL_LM, dropout=RATE), variables, (tokens,), weights,
                                    jax.random.PRNGKey(4))
    assert len(masks) == 2 * SMALL_LM["num_layers"]  # attention weights, then the FFN's hidden, a layer
    rng = DropoutRng(masks=[t(m) for m in masks])
    got = port(t(tokens).long(), train=True, rng=rng)
    assert not rng.masks  # every mask consumed, in flax's order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=OUT_ATOL)
    torch.sum(got * t(weights)).backward()
    _check_grads(port, lm_state_dict({"params": to_numpy(grads)}))


def test_asr_dropout_on_flax_masks(flax_dropout):
    port = ASRModel(**SMALL_ASR, dropout=RATE, generator=_gen(5), device="cpu")
    variables = {"params": jax.tree_util.tree_map(np.array, to_numpy(asr_variables(port)["params"]))}
    feats, tokens, lens = _asr_inputs(seed=6)
    weights = np.random.default_rng(7).standard_normal((*tokens.shape, SMALL_ASR["output_neurons"])).astype(
        np.float32)
    out, grads, masks = _flax_train(JaxASRModel(**SMALL_ASR, dropout=RATE), variables, (feats, tokens, lens),
                                    weights, jax.random.PRNGKey(8))
    # encoder: attention, FFN; decoder: self-attention, cross-attention, FFN
    assert len(masks) == 2 * SMALL_ASR["num_encoder_layers"] + 3 * SMALL_ASR["num_decoder_layers"]
    rng = DropoutRng(masks=[t(m) for m in masks])
    got = port(t(feats), t(tokens).long(), t(lens), train=True, rng=rng)
    assert not rng.masks
    for g, w in zip(got, out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=OUT_ATOL)
    torch.sum(got[-1] * t(weights)).backward()
    _check_grads(port, asr_state_dict({"params": to_numpy(grads)}))


def test_eval_mode_is_dropout_free_and_own_draws_keep_the_rate():
    port = TransformerLM(**SMALL_LM, dropout=RATE, generator=_gen(9), device="cpu")
    plain = TransformerLM(**SMALL_LM, generator=_gen(9), device="cpu")
    tokens = t(_lm_tokens()).long()
    with torch.no_grad():
        assert torch.equal(port(tokens), plain(tokens))
        assert torch.equal(port(tokens, train=False, rng=DropoutRng(_gen(1))), plain(tokens, train=True))
        rng = DropoutRng(_gen(10), record=True)
        port(tokens, train=True, rng=rng)
    kept = torch.cat([m.flatten() for m in rng.used]).float()
    n = kept.numel()
    assert abs(float(kept.mean()) - 0.9) <= 3 * np.sqrt(0.9 * 0.1 / n), (float(kept.mean()), n)
    with pytest.raises(ValueError, match="DropoutRng"):
        port(tokens, train=True)


def test_jax_attention_dropout_is_refused():
    """The JAX package's own LM at dropout > 0 in train mode: flax refuses the
    ``nn.Dropout`` its attention builds outside ``setup``/``@compact``."""
    model = jax_tr.TransformerLM(**SMALL_LM, dropout=RATE)
    tokens = _lm_tokens()
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), tokens)
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), variables)
    with pytest.raises(Exception, match="Dropout"):
        model.apply(params, tokens, True, rngs={"dropout": jax.random.PRNGKey(1)})
    model.apply(params, tokens, False)  # eval mode runs

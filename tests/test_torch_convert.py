"""Weight bridge round trip: torch -> flax through the JAX package's
``port_weights.*_from_torch``, then back through the port's converter, must
give the original tensors bit for bit (the ConvTranspose flip included)."""

import numpy as np
import pytest
import torch

from speech_anonymization_tpu.utils.port_weights import (
    batchnorm_from_torch,
    conv1d_from_torch,
    conv_transpose1d_from_torch,
    instancenorm_from_torch,
    linear_from_torch,
)
from speech_anonymization_tpu_torch.utils import convert


def _random_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for tensor in module.state_dict().values():
            if tensor.is_floating_point():
                tensor.copy_(torch.randn(tensor.shape, generator=gen))
    return module


def _assert_round_trip(module: torch.nn.Module, back: dict) -> None:
    want = {k: v for k, v in module.state_dict().items() if k != "num_batches_tracked"}
    back = {k: v for k, v in back.items() if k != "num_batches_tracked"}
    assert back.keys() == want.keys()
    for k, v in want.items():
        got = np.asarray(back[k])
        assert got.shape == tuple(v.shape), k
        np.testing.assert_array_equal(got, v.numpy(), err_msg=k)


@pytest.mark.parametrize(
    "kind,module,forward,backward",
    [
        ("linear", torch.nn.Linear(7, 5), linear_from_torch, convert.linear_from_flax),
        ("conv1d", torch.nn.Conv1d(4, 6, 5), conv1d_from_torch, convert.conv1d_from_flax),
        ("conv_transpose1d", torch.nn.ConvTranspose1d(4, 3, 5, stride=2),
         conv_transpose1d_from_torch, convert.conv_transpose1d_from_flax),
        ("instancenorm", torch.nn.InstanceNorm1d(6, affine=True),
         instancenorm_from_torch, convert.instancenorm_from_flax),
    ],
)
def test_round_trip_is_bit_identical(kind, module, forward, backward):
    _random_(module, seed=len(kind))
    flax_params = forward(module.weight, module.bias)
    _assert_round_trip(module, backward(flax_params))


def test_batchnorm_round_trip_is_bit_identical():
    bn = _random_(torch.nn.BatchNorm1d(6), seed=3)
    p, s = batchnorm_from_torch(bn.weight, bn.bias, bn.running_mean, bn.running_var)
    _assert_round_trip(bn, convert.batchnorm_from_flax(p, s))


def test_conv_transpose_flip_is_not_a_no_op():
    """An asymmetric kernel must come back flipped relative to the flax layout."""
    ct = _random_(torch.nn.ConvTranspose1d(2, 2, 5), seed=9)
    flax_kernel = conv_transpose1d_from_torch(ct.weight, ct.bias)["kernel"]
    unflipped = np.transpose(flax_kernel, (1, 2, 0))
    assert not np.array_equal(unflipped, ct.weight.detach().numpy())


def test_unknown_flax_layer_raises():
    with pytest.raises(KeyError):
        convert.indexed_state_dict({"params": {"LayerNorm_0": {}}})


# -- the frozen models' inverses (their checkpoints in the JAX package's format) -------


def _inverse_round_trip(module, variables: dict, forward, flax_shapes) -> None:
    """``variables`` (the inverse's output) has flax's own tree and shapes, and
    the forward converter brings every tensor back bit for bit."""
    import jax

    tree = jax.tree_util.tree_map(lambda x: np.asarray(x.numpy() if torch.is_tensor(x) else x), variables)
    assert jax.tree_util.tree_map(np.shape, tree) == jax.tree_util.tree_map(lambda x: x.shape, flax_shapes)
    _assert_round_trip(module, forward(tree))


def test_asr_variables_inverts_asr_state_dict():
    import jax
    import jax.numpy as jnp

    from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
    from speech_anonymization_tpu_torch.models import ASRModel

    widths = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64, output_neurons=24)
    model = _random_(ASRModel(**widths, device="cpu"), 5)
    shapes = jax.eval_shape(lambda: JaxASRModel(**widths).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)), jnp.zeros((1, 3), jnp.int32), jnp.ones((1,))))
    _inverse_round_trip(model, convert.asr_variables(model), convert.asr_state_dict, dict(shapes))


@pytest.mark.parametrize("sb_compat", [False, True])
def test_lm_variables_inverts_lm_state_dict(sb_compat):
    import jax
    import jax.numpy as jnp

    from speech_anonymization_tpu.models.transformer import TransformerLM as JaxLM
    from speech_anonymization_tpu_torch.models import TransformerLM

    widths = dict(vocab=40, d_model=64, nhead=4, num_layers=2, d_ffn=128)
    model = _random_(TransformerLM(**widths, sb_compat=sb_compat, device="cpu"), 6)
    shapes = jax.eval_shape(lambda: JaxLM(**widths, sb_compat=sb_compat).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    _inverse_round_trip(model, convert.lm_variables(model), convert.lm_state_dict, dict(shapes))


def test_xvector_variables_inverts_indexed_state_dict():
    import jax
    import jax.numpy as jnp

    from speech_anonymization_tpu.models import Xvector as JaxXvector
    from speech_anonymization_tpu.models import XvectorClassifier as JaxXvectorClassifier
    from speech_anonymization_tpu_torch.models import Xvector, XvectorClassifier

    emb = _random_(Xvector(tdnn_channels=(16, 16, 16, 16, 24), lin_neurons=8, device="cpu"), 7)
    clf = _random_(XvectorClassifier(lin_neurons=8, device="cpu"), 8)
    emb_shapes = jax.eval_shape(lambda: JaxXvector(tdnn_channels=(16, 16, 16, 16, 24), lin_neurons=8).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 20, 80))))
    clf_shapes = jax.eval_shape(lambda: JaxXvectorClassifier(lin_neurons=8).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8))))
    _inverse_round_trip(emb, convert.xvector_variables(emb), convert.indexed_state_dict, dict(emb_shapes))
    _inverse_round_trip(clf, convert.xvector_variables(clf), convert.indexed_state_dict, dict(clf_shapes))

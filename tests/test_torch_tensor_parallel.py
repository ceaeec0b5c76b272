"""The port's ``parallel/sharding_rules.py``: tensor parallelism for the ASR.

  * The analog of ``tests/test_tensor_parallel.py::test_specs_shard_attention_and_ffn``:
    ``asr_param_specs`` of the port's ``ASRModel`` equals the JAX package's
    ``asr_param_specs`` parameter by parameter, read through
    ``utils/convert.py``: each flax leaf filled with its index along the
    ``model``-split axis (zeros where replicated) and converted to the port's
    names and layout must vary along exactly the dim the port splits, in
    contiguous blocks, and nowhere for a replicated parameter; the q/k/v
    biases are replicated, as in JAX.
  * The analog of ``test_tp_grad_matches_unsharded``: four gloo ranks on a
    (data 2 x model 2) mesh (``tests/torch_parallel_helpers.py``
    ``tensor_parallel_ranks``), each holding its slices
    (``shard_asr_params``) and its rows of the batch: the KLdiv gradients,
    reduced by ``reduce_tp_grads``, equal the unsharded model's on the whole
    batch at atol 2e-5 (the JAX test's tolerance), each split parameter's
    gradient the slice of the unsharded one; before the reduction a q bias's
    gradient lies on the rank's own heads alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.parallel.sharding_rules import asr_param_specs as jax_asr_param_specs
from speech_anonymization_tpu_torch.losses.basic import kldiv_loss
from speech_anonymization_tpu_torch.models import ASRModel
from speech_anonymization_tpu_torch.parallel.sharding_rules import asr_param_specs
from speech_anonymization_tpu_torch.utils.convert import asr_state_dict
from speech_anonymization_tpu_torch.utils.seeded_init import seeded_init_
from tests import torch_parallel_helpers as helpers
import tests.torch_port_helpers  # noqa: F401,E402  (caps torch at one thread)

SMALL = dict(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=1, d_ffn=64, output_neurons=48)
ATOL = 2e-5  # tests/test_tensor_parallel.py::test_tp_grad_matches_unsharded


def _split_dim(values: np.ndarray):
    """The one dim along which a converted index map varies (None if none)."""
    varying = [d for d in range(values.ndim) if np.any(np.diff(values, axis=d) != 0)]
    assert len(varying) <= 1, varying
    if not varying:
        return None
    assert np.all(np.diff(values, axis=varying[0]) >= 0)  # contiguous blocks, in order
    return varying[0]


def test_specs_equal_jax_through_convert():
    jm = JaxASRModel(**SMALL)
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 24, 80)),
                               jnp.zeros((1, 6), jnp.int32), jnp.ones((1,)))
    specs = jax_asr_param_specs(variables["params"])

    def index_map(leaf, spec):
        out = np.zeros(leaf.shape, np.float32)
        if "model" in tuple(spec):
            axis = tuple(spec).index("model")
            shape = [1] * len(leaf.shape)
            shape[axis] = leaf.shape[axis]
            out += 1.0 + np.arange(leaf.shape[axis], dtype=np.float32).reshape(shape)
        return out

    maps = jax.tree_util.tree_map(index_map, variables["params"], specs)
    want = {k: _split_dim(v) for k, v in asr_state_dict({"params": maps}).items()}
    got = asr_param_specs(ASRModel(**SMALL, device="cpu"))
    assert got == want
    split = {k for k, d in got.items() if d is not None}
    assert {k.rsplit(".", 2)[-2] for k in split} == {"q", "k", "v", "out", "dense0", "dense1"}
    for k, d in got.items():
        if k.endswith((".q.bias", ".k.bias", ".v.bias", ".out.bias", ".dense1.bias")):
            assert d is None, k
    assert any("decoder_layers" in k and ".ff.dense0" in k for k in split)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    folder = tmp_path_factory.mktemp("tp")
    model = seeded_init_(ASRModel(**SMALL, device="cpu"), 7)
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((8, 24, 80)).astype(np.float32), np.ones((8, 6), np.int64),
             np.ones(8, np.float32), np.ones((8, 6), np.int64))
    torch.save({"widths": SMALL, "weights": {k: v.numpy() for k, v in model.state_dict().items()},
                "batch": batch}, folder / "inputs.pt")
    feats, tokens, lens, targets = (torch.from_numpy(x) for x in batch)
    loss = kldiv_loss(model(feats, tokens, lens)[3], targets, None)
    grads = helpers.grads_of(loss, model)
    return float(loss.detach()), grads, asr_param_specs(model), helpers.spawn(helpers.tensor_parallel_ranks, 4, folder)


def test_tp_grads_equal_unsharded(tp_run):
    loss, grads, specs, ranks = tp_run
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-6)
        model_index = r["coords"][1]
        for k, g in grads.items():
            want = g if specs[k] is None else g.chunk(2, specs[k])[model_index]
            assert tuple(r["shapes"][k]) == tuple(want.shape), k
            np.testing.assert_allclose(r["grads"][k].numpy(), want.numpy(), atol=ATOL, err_msg=k)


def test_replicated_qkv_bias_gradient_lies_on_the_rank_heads(tp_run):
    """The trap of the rules: before the model-axis sum a rank's q bias
    gradient is zero outside its own heads' slice."""
    _, _, _, ranks = tp_run
    for r in ranks:
        raw, width = r["raw_q_bias"], SMALL["d_model"] // 2
        own = slice(r["coords"][1] * width, (r["coords"][1] + 1) * width)
        outside = torch.ones_like(raw, dtype=torch.bool)
        outside[own] = False
        assert torch.all(raw[outside] == 0) and torch.any(raw[own] != 0)

"""The port's loaders for the reference's torch checkpoints against the JAX
package's, on the same SpeechBrain-layout files (CPU).

The files are written here with ``torch.save`` from seeded state dicts
(``tools/sb_layout.py``), whose key tables are first held against the torch
replicas of SpeechBrain's modules in ``tests/test_reference_asr_port.py``
and ``tests/test_reference_ckpt_port.py``. Then the same file goes through
JAX's loader and the port's. Tolerances: the flax-layout trees equal element
for element; ASR and LM outputs within 1e-4 of JAX's (and of the torch
replica's forward); FC-AE reconstruction, its HEAD classifier's and the
classifier head's log-probs within 1e-5; the normalizer, Noam and counter
values exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_anonymization_tpu.models.asr as jax_asr
import speech_anonymization_tpu.models.autoencoders as jax_autoencoders
import speech_anonymization_tpu.models.transformer as jax_transformer
import speech_anonymization_tpu.models.xvector as jax_xvector
from speech_anonymization_tpu.recipes.gender_classifier import load_recon_model as jax_load_recon_model
from speech_anonymization_tpu.train.schedulers import NoamScheduler as JaxNoam
from speech_anonymization_tpu.utils import reference_ckpts as jax_ref
from speech_anonymization_tpu.utils import sb_compat as jax_sb
from speech_anonymization_tpu_torch.recipes.gender_classifier import load_recon_model
from speech_anonymization_tpu_torch.tools import sb_layout
from speech_anonymization_tpu_torch.train.schedulers import NoamScheduler
from speech_anonymization_tpu_torch.utils import reference_ckpts as ref
from speech_anonymization_tpu_torch.utils import sb_compat
from speech_anonymization_tpu_torch.utils.convert import anonymizer_variables, asr_variables, lm_variables
from tests.test_reference_asr_port import SBCNN, SBLinear, SBTransformerASR, SBTransformerLM
from tests.test_reference_ckpt_port import _TorchFCAE, _TorchFCSexClassifier
from tests.torch_port_helpers import shape_init, t

ASR = dict(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2, d_ffn=48)
VOCAB = 40
LM = dict(d_model=32, nhead=4, num_layers=3, d_ffn=48)
MODEL_ATOL = 1e-4
SMALL_ATOL = 1e-5
TOKENS = np.array([[1, 5, 6, 9, 3, 4], [1, 7, 3, 0, 0, 0]])


@pytest.fixture(autouse=True)
def traced_jax_templates(monkeypatch):
    """JAX's loaders merge the file over a fresh ``init`` of the target
    module; trace it rather than compile it (every parameter compared here is
    overwritten from the file)."""
    for module, name in ((jax_asr, "ASRModel"), (jax_transformer, "TransformerLM"),
                         (jax_autoencoders, "FullyConnectedAutoencoder"), (jax_xvector, "XvectorClassifier")):
        monkeypatch.setattr(module, name, shape_init(getattr(module, name)))


def _asr_layout():
    return sb_layout.asr_layout(ASR["d_model"], ASR["num_encoder_layers"], ASR["num_decoder_layers"],
                                ASR["d_ffn"], VOCAB)


def _lm_layout():
    return sb_layout.lm_layout(LM["d_model"], LM["num_layers"], LM["d_ffn"], VOCAB)


def _asr_replica():
    d = ASR
    return torch.nn.ModuleList([
        SBCNN(80),
        SBTransformerASR(VOCAB, 20 * 512, d["d_model"], d["nhead"], d["num_encoder_layers"],
                         d["num_decoder_layers"], d["d_ffn"]),
        SBLinear(d["d_model"], VOCAB), SBLinear(d["d_model"], VOCAB)]).eval()


def _lm_replica():
    return SBTransformerLM(VOCAB, LM["d_model"], LM["nhead"], LM["num_layers"], LM["d_ffn"]).eval()


class _FCAE(torch.nn.Module):
    """The reference's FC-AE module tree: ``encoder``, ``decoder`` and a sex head."""

    def __init__(self, head: bool):
        super().__init__()
        ae = _TorchFCAE()
        self.encoder, self.decoder = ae.encoder, ae.decoder
        self.sex_classifier = _TorchFCSexClassifier() if head else _DummyHead()


class _DummyHead(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1, self.fc2 = torch.nn.Linear(1024, 512), torch.nn.Linear(512, 2)


def _shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


@pytest.mark.parametrize("name", ["asr", "lm", "fcae_head", "fcae_dummy"])
def test_layout_tables_match_speechbrain_replicas(name):
    want = {"asr": _asr_replica, "lm": _lm_replica,
            "fcae_head": lambda: torch.nn.ModuleList([_FCAE(True)]),
            "fcae_dummy": lambda: torch.nn.ModuleList([_FCAE(False)])}[name]()
    got = {"asr": _asr_layout, "lm": _lm_layout, "fcae_head": lambda: sb_layout.fcae_layout(True),
           "fcae_dummy": lambda: sb_layout.fcae_layout(False)}[name]()
    assert got == _shapes(want)


def _write(tmp_path, name: str, layout: dict, seed: int) -> tuple[str, dict]:
    path = str(tmp_path / name)
    return path, sb_layout.write_seeded(path, layout, seed)


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=jax.tree_util.keystr(path))


def _numpy(tree):
    return jax.tree_util.tree_map(lambda x: x.detach().numpy() if hasattr(x, "detach") else np.asarray(x),
                                  tree)


def test_asr_loader_matches_jax_and_replica(tmp_path):
    path, sd = _write(tmp_path, "asr.ckpt", _asr_layout(), 0)
    tree = ref.port_sb_asr_state_dict(sb_compat.load_state_dict_ckpt(path), ASR["nhead"],
                                      ASR["num_encoder_layers"], ASR["num_decoder_layers"])
    want_tree = jax_ref.port_sb_asr_state_dict(jax_sb.load_state_dict_ckpt(path), ASR["nhead"],
                                               ASR["num_encoder_layers"], ASR["num_decoder_layers"])
    _assert_trees_equal(tree, want_tree)
    assert sum(np.size(x) for x in jax.tree_util.tree_leaves(tree)) == sum(
        v.numel() for k, v in sd.items())

    jm, jv = jax_ref.load_reference_asr(path, **ASR, output_neurons=VOCAB)
    pm = ref.load_reference_asr(path, **ASR, output_neurons=VOCAB, device="cpu")
    assert not pm.training and pm.sb_compat
    _assert_trees_equal(_numpy(asr_variables(pm))["params"], jv["params"])

    feats = np.random.default_rng(0).standard_normal((2, 12, 80)).astype(np.float32)
    lens = np.ones(2, np.float32)
    want = jax.jit(jm.apply)(jv, jnp.asarray(feats), jnp.asarray(TOKENS), jnp.asarray(lens))
    with torch.no_grad():
        got = pm(t(feats), t(TOKENS).long(), t(lens))
        replica = _asr_replica()
        replica.load_state_dict(sd)
        enc_t, dec_t = replica[1](replica[0](t(feats)), t(TOKENS).long())
    valid = TOKENS != 0  # decoder rows at pad positions are garbage in both
    for name, g, w in zip(("enc", "dec", "p_ctc", "p_seq"), got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in ("dec", "p_seq"):
            g, w = g[valid], w[valid]
        np.testing.assert_allclose(g, w, atol=MODEL_ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(got[0].numpy(), enc_t.numpy(), atol=MODEL_ATOL, rtol=0)
    np.testing.assert_allclose(got[1].numpy()[valid], dec_t.numpy()[valid], atol=MODEL_ATOL, rtol=0)


def test_lm_loader_matches_jax_and_replica(tmp_path):
    path, sd = _write(tmp_path, "lm.ckpt", _lm_layout(), 1)
    tree = ref.port_sb_lm_state_dict(sb_compat.load_state_dict_ckpt(path), LM["nhead"], LM["num_layers"])
    _assert_trees_equal(tree, jax_ref.port_sb_lm_state_dict(jax_sb.load_state_dict_ckpt(path), LM["nhead"],
                                                            LM["num_layers"]))
    jl, jv = jax_ref.load_reference_lm(path, **LM, vocab=VOCAB)
    pl = ref.load_reference_lm(path, **LM, vocab=VOCAB, device="cpu")
    assert pl.sb_compat
    _assert_trees_equal(_numpy(lm_variables(pl))["params"], jv["params"])
    toks = TOKENS[:, :5]
    want = jax.jit(jl.apply)(jv, jnp.asarray(toks))
    with torch.no_grad():
        got = pl(t(toks).long())
        replica = _lm_replica()
        replica.load_state_dict(sd)
        got_t = replica(t(toks).long())
    valid = toks != 0
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=MODEL_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy()[valid], got_t.numpy()[valid], atol=MODEL_ATOL, rtol=0)


@pytest.mark.parametrize("head", [True, False])
def test_fcae_loader_matches_jax(tmp_path, head):
    path, _ = _write(tmp_path, "model.ckpt", sb_layout.fcae_layout(head), 2)
    jm, jv, j_ported = jax_ref.load_reference_fcae(path)
    pm, ported = ref.load_reference_fcae(path, device="cpu")
    assert ported == j_ported == head
    got_vars = _numpy(anonymizer_variables(pm))
    if head:
        _assert_trees_equal(got_vars, jv)
    else:  # only the encoder and decoder come from the file
        _assert_trees_equal({k: got_vars["params"][k] for k in ref.FCAE_ENC_DEC_SPEC},
                            {k: jv["params"][k] for k in ref.FCAE_ENC_DEC_SPEC})
    feats = np.random.default_rng(3).standard_normal((3, 50, 80)).astype(np.float32)
    recon_j, sex_j = jax.jit(functools.partial(jm.apply, train=False))(jv, jnp.asarray(feats))
    with torch.no_grad():
        recon, sex = pm.eval()(t(feats))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=SMALL_ATOL, rtol=0)
    if head:
        np.testing.assert_allclose(sex.numpy(), np.asarray(sex_j), atol=SMALL_ATOL, rtol=0)


@pytest.mark.parametrize("emb_dim,lin_neurons", [(16, 16), (24, 12)])
def test_classifier_head_loader_matches_jax(tmp_path, emb_dim, lin_neurons):
    path, _ = _write(tmp_path, "classifier.ckpt",
                     sb_layout.classifier_head_layout(emb_dim, lin_neurons, 2), 4)
    jm, jv = jax_ref.load_reference_classifier_head(path)
    pm = ref.load_reference_classifier_head(path, device="cpu").eval()
    emb = (np.random.default_rng(5).standard_normal((5, emb_dim)) * 3.0).astype(np.float32)
    want = jax.jit(functools.partial(jm.apply, train=False))(jv, jnp.asarray(emb))
    with torch.no_grad():
        got = pm(t(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SMALL_ATOL, rtol=0)


def test_normalizer_noam_counter_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    norm_path, noam_path, counter_path = (str(tmp_path / f) for f in (
        "normalizer.ckpt", "noam_scheduler.ckpt", "counter.ckpt"))
    torch.save({"count": 123456, "glob_mean": torch.from_numpy(rng.standard_normal(80).astype(np.float32)),
                "glob_std": torch.from_numpy(rng.uniform(0.5, 2.0, 80).astype(np.float32)),
                "spk_dict_mean": {}, "spk_dict_std": {}, "spk_dict_count": {}}, norm_path)
    torch.save({"losses": [3.5, 2.25, 1.125], "n_steps": 31250, "normalize": 768 ** -0.5}, noam_path)
    with open(counter_path, "w") as f:
        f.write("7\n")
    got, want = sb_compat.load_normalizer_ckpt(norm_path, device="cpu"), jax_sb.load_normalizer_ckpt(norm_path)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sched, jsched = NoamScheduler(), JaxNoam(lr_initial=1.0, n_warmup_steps=25000, model_size=768)
    assert sb_compat.load_noam_ckpt(noam_path, sched) == jax_sb.load_noam_ckpt(noam_path, jsched)
    assert (sched.n_steps, sched.current_lr, sched.losses) == (jsched.n_steps, jsched.current_lr,
                                                               jsched.losses)
    assert sb_compat.load_counter_ckpt(counter_path) == jax_sb.load_counter_ckpt(counter_path) == 7


@pytest.mark.parametrize("kind,key", [("asr", "1.decoder.norm.norm.weight"),
                                      ("lm", "output_proj.layers.2.w.weight"),
                                      ("fcae", "0.decoder.4.weight")])
def test_missing_key_raises_in_both(tmp_path, kind, key):
    layout = {"asr": _asr_layout, "lm": _lm_layout, "fcae": sb_layout.fcae_layout}[kind]()
    sd = sb_layout.seeded_state_dict(layout, 7)
    del sd[key]
    path = str(tmp_path / "x.ckpt")
    torch.save(sd, path)
    calls = {"asr": (functools.partial(jax_ref.port_sb_asr_state_dict, nhead=4, num_encoder_layers=2,
                                       num_decoder_layers=2),
                     lambda p: ref.load_reference_asr(p, **ASR, output_neurons=VOCAB, device="cpu")),
             "lm": (functools.partial(jax_ref.port_sb_lm_state_dict, nhead=4, num_layers=3),
                    lambda p: ref.load_reference_lm(p, **LM, vocab=VOCAB, device="cpu")),
             "fcae": (lambda s: jax_ref.port_state_dict(s, jax_ref.FCAE_ENC_DEC_SPEC),
                      lambda p: ref.load_reference_fcae(p, device="cpu"))}[kind]
    with pytest.raises(KeyError):
        calls[0](jax_sb.load_state_dict_ckpt(path))
    with pytest.raises(KeyError):
        calls[1](path)


def test_find_best_ckpt_dir_matches_jax(tmp_path):
    for name in ("CKPT+2022-03-23+18-48-15+00", "CKPT+2022-05-06+15-54-03+00", "other"):
        (tmp_path / name).mkdir()
    assert ref.find_best_ckpt_dir(str(tmp_path)) == jax_ref.find_best_ckpt_dir(str(tmp_path)) == str(
        tmp_path / "CKPT+2022-05-06+15-54-03+00")
    empty = tmp_path / "other"
    for fn in (ref.find_best_ckpt_dir, jax_ref.find_best_ckpt_dir):
        with pytest.raises(FileNotFoundError):
            fn(str(empty))


@pytest.mark.parametrize("where", ["save", "ckpt_dir"])
def test_load_recon_model_reads_reference_checkpoint(tmp_path, where):
    """gender_classifier's recon variant on a reference ``save/`` directory (or
    one ``CKPT+*`` directory of it) against the JAX package's on the same files."""
    save = tmp_path / "save"
    ckpt = save / "CKPT+2022-03-23+18-48-15+00"
    _write(ckpt, "model.ckpt", sb_layout.fcae_layout(True), 8)
    (save / "CKPT+2022-01-01+00-00-00+00").mkdir()  # an older one, not picked
    target = str(save if where == "save" else ckpt)
    jm, jv = jax_load_recon_model(target, model_type="fcae")
    pm = load_recon_model(target, model_type="fcae", device="cpu")
    assert not pm.training and not any(p.requires_grad for p in pm.parameters())
    feats = np.random.default_rng(9).standard_normal((2, 30, 80)).astype(np.float32)
    recon_j, sex_j = jax.jit(functools.partial(jm.apply, train=False))(jv, jnp.asarray(feats))
    with torch.no_grad():
        recon, sex = pm(t(feats))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=SMALL_ATOL, rtol=0)
    np.testing.assert_allclose(sex.numpy(), np.asarray(sex_j), atol=SMALL_ATOL, rtol=0)


def test_port_weights_helpers_match_jax():
    """The port's numpy copy of ``utils/port_weights.py``: each converter,
    ``port_state_dict`` over every kind of its spec language, and
    ``merge_params``, equal to the JAX package's."""
    from speech_anonymization_tpu.utils import port_weights as jax_pw
    from speech_anonymization_tpu_torch.utils import port_weights as pw

    sd = sb_layout.seeded_state_dict({"lin.weight": (3, 5), "lin.bias": (3,), "conv.weight": (4, 2, 3, 3),
                                      "conv.bias": (4,), "emb.weight": (7, 5),
                                      **{f"bn.{k}": (6,) for k in ("weight", "bias", "running_mean",
                                                                  "running_var")}}, 10)
    for name, args in (("linear_from_torch", ("lin",)), ("conv2d_from_torch", ("conv",))):
        _assert_trees_equal(getattr(pw, name)(sd[f"{args[0]}.weight"], sd[f"{args[0]}.bias"]),
                            getattr(jax_pw, name)(sd[f"{args[0]}.weight"], sd[f"{args[0]}.bias"]))
    bn = [sd[f"bn.{k}"] for k in ("weight", "bias", "running_mean", "running_var")]
    _assert_trees_equal(pw.batchnorm_from_torch(*bn), jax_pw.batchnorm_from_torch(*bn))
    _assert_trees_equal(pw.embedding_from_torch(sd["emb.weight"]), jax_pw.embedding_from_torch(sd["emb.weight"]))
    spec = {"a/Dense_0": ("linear", "lin"), "Conv_0": ("conv2d", "conv"), "a/BatchNorm_0": ("batchnorm", "bn"),
            "embed": ("embedding", "emb")}
    got, want = pw.port_state_dict(sd, spec), jax_pw.port_state_dict(sd, spec)
    _assert_trees_equal(got, want)
    base = {"a": {"Dense_0": {"kernel": np.zeros((5, 3))}, "keep": np.ones(2)}, "b": np.ones(1)}
    _assert_trees_equal(pw.merge_params(base, got[0]), jax_pw.merge_params(base, want[0]))
    with pytest.raises(KeyError):
        pw.port_state_dict({k: v for k, v in sd.items() if k != "bn.running_var"}, spec)

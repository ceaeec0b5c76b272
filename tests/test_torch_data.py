"""The port's input pipeline (``data/``) against the JAX package's (CPU), on the
same files:

  * audio: ``read_audio`` bit-equal on PCM16 WAV by the native library and by
    the numpy reader, and on FLAC (``tests/test_flac.py``'s writer); ``write_wav``
    the same bytes;
  * on ``make_fake_librispeech``'s corpus: ``prepare_librispeech``'s CSVs
    byte-equal; the anonymizer recipe's ``dataio_prepare`` + ``make_loaders``
    giving equal train, valid and test batches over two epochs (order, ids,
    padded ``sig`` and its lengths, ``gender``, ``wrd``, ``tokens_bos`` /
    ``tokens_eos`` / ``tokens``), also after a mid-epoch ``state_dict`` round
    trip, and through ``PrefetchLoader``;
  * the tokenizer: trained pieces and log-probs equal, ids equal by the native
    and the Python encoders, ``decode_ids`` equal, ``load_sentencepiece`` equal on
    ``tests/test_spm_reader.py``'s model bytes;
  * the label encoder's file, and ``synth.build_corpus``'s WAVs byte-equal at a
    tiny size.
"""

import filecmp
import os

import numpy as np
import pytest

from speech_anonymization_tpu.data import audio as jax_audio
from speech_anonymization_tpu.data import synth as jax_synth
from speech_anonymization_tpu.data.encoder import CategoricalEncoder as JaxEncoder
from speech_anonymization_tpu.data.librispeech import prepare_librispeech as jax_prepare
from speech_anonymization_tpu.data.prefetch import PrefetchLoader as JaxPrefetchLoader
from speech_anonymization_tpu.data.tokenizer import UnigramTokenizer as JaxTokenizer
from speech_anonymization_tpu.recipes import anonymizer as jax_recipe
from speech_anonymization_tpu_torch.data import audio, synth
from speech_anonymization_tpu_torch.data.encoder import CategoricalEncoder
from speech_anonymization_tpu_torch.data.librispeech import prepare_librispeech
from speech_anonymization_tpu_torch.data.prefetch import PrefetchLoader
from speech_anonymization_tpu_torch.data.tokenizer import UnigramTokenizer
from speech_anonymization_tpu_torch.recipes import anonymizer as recipe
from tests.fixtures import make_fake_librispeech
from tests.test_flac import encode_flac_verbatim
from tests.test_spm_reader import ENTRIES, _model_bytes

SPLIT = "train-clean"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ls"))
    make_fake_librispeech(root, split=SPLIT, utts_per_speaker=3, duration_s=0.7)
    return root


def _wav(path, n, seed):
    x = np.random.default_rng(seed).uniform(-1.2, 1.2, n)
    audio.write_wav(str(path), x)
    return x


# -- audio ---------------------------------------------------------------------------


def test_write_wav_bytes_match(tmp_path):
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 1001)
    audio.write_wav(str(tmp_path / "a.wav"), x, 8000)
    jax_audio.write_wav(str(tmp_path / "b.wav"), x, 8000)
    assert filecmp.cmp(tmp_path / "a.wav", tmp_path / "b.wav", shallow=False)


def _count_calls(monkeypatch, module, name: str) -> list:
    """Record each call of ``module.name`` (its arguments) in the list returned."""
    calls, fn = [], getattr(module, name)

    def counted(*args):
        calls.append(args)
        return fn(*args)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_read_audio_wav_bit_equal_both_readers(tmp_path, monkeypatch):
    path = str(tmp_path / "x.wav")
    _wav(path, 4000, 1)
    assert audio._native_lib() and jax_audio._native_lib()
    numpy_reads = _count_calls(monkeypatch, audio, "_read_wav_numpy")
    native, sr = audio.read_audio(path, return_sr=True)
    assert numpy_reads == [] and sr == 16000
    want = jax_audio.read_audio(path)
    assert native.dtype == want.dtype == np.float32 and np.array_equal(native, want)
    numpy_wav, numpy_sr = audio._read_wav_numpy(path)
    want_numpy, _ = jax_audio._read_wav_numpy(path)
    assert numpy_sr == 16000 and np.array_equal(numpy_wav, want_numpy)
    assert np.array_equal(numpy_wav, native)


def test_read_audio_without_the_library_takes_the_numpy_reader(tmp_path, monkeypatch):
    path = str(tmp_path / "x.wav")
    _wav(path, 999, 2)
    monkeypatch.setattr(audio, "_NATIVE", False)
    numpy_reads = _count_calls(monkeypatch, audio, "_read_wav_numpy")
    got = audio.read_audio(path)
    assert numpy_reads == [(path,)]
    assert np.array_equal(got, jax_audio._read_wav_numpy(path)[0])


def test_read_audio_flac_bit_equal(tmp_path):
    wav = (np.random.default_rng(3).standard_normal(777) * 0.3).astype(np.float32)
    path = str(tmp_path / "x.flac")
    with open(path, "wb") as f:
        f.write(encode_flac_verbatim(wav, block=256))
    got, sr = audio.read_audio(path, return_sr=True)
    want, want_sr = jax_audio.read_audio(path, return_sr=True)
    assert sr == want_sr == 16000 and len(got) == 777
    assert np.array_equal(got, want)
    assert audio.audio_duration(path) == jax_audio.audio_duration(path)


# -- manifests and loaders ---------------------------------------------------------------


@pytest.fixture(scope="module")
def manifests(corpus, tmp_path_factory):
    """Each package's CSVs of the corpus, in a folder of its own."""
    out = {}
    for name, prepare in (("port", prepare_librispeech), ("jax", jax_prepare)):
        folder = str(tmp_path_factory.mktemp(f"csv_{name}"))
        prepare(corpus, tr_splits=[SPLIT], save_folder=folder, merge_lst=[SPLIT],
                merge_name=os.path.join(folder, "train.csv"))
        out[name] = folder
    return out


def test_prepare_librispeech_csvs_byte_equal(manifests):
    for name in (f"{SPLIT}.csv", "train.csv"):
        assert filecmp.cmp(os.path.join(manifests["port"], name), os.path.join(manifests["jax"], name),
                           shallow=False), name


@pytest.fixture(scope="module")
def tokenizers(corpus):
    """Each package's tokenizer, trained on the corpus's transcripts."""
    lines = []
    for dirpath, _, files in sorted(os.walk(corpus)):
        for f in sorted(files):
            if f.endswith(".trans.txt"):
                lines += [ln.split(" ", 1)[1] for ln in open(os.path.join(dirpath, f)).read().splitlines()]
    return UnigramTokenizer().train(lines, vocab_size=40), JaxTokenizer().train(lines, vocab_size=40), lines


def _hparams(manifests, name, **extra):
    csv = os.path.join(manifests[name], f"{SPLIT}.csv")
    return {"data_folder": manifests[name], "train_csv": csv, "valid_csv": csv, "test_csv": [csv],
            "batch_size": 4, "seed": 11, "sorting": "random", **extra}


def _loaders(module, hparams, tokenizer):
    train, valid, tests = module.dataio_prepare(hparams, tokenizer=tokenizer)
    return module.make_loaders(hparams, train, valid, tests)


def _batches(loader, epochs=(1, 2)):
    out = []
    for epoch in epochs:
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)
        out += list(loader)
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == ["id", "sig", "gender", "wrd", "tokens_bos", "tokens_eos", "tokens"]
        assert g.id == w.id and g.wrd == w.wrd
        assert g.gender.dtype == w.gender.dtype and np.array_equal(g.gender, w.gender)
        for key in ("sig", "tokens_bos", "tokens_eos", "tokens"):
            (gx, gl), (wx, wl) = getattr(g, key), getattr(w, key)
            assert gx.dtype == wx.dtype and np.array_equal(gx, wx), key
            assert gl.dtype == wl.dtype and np.array_equal(gl, wl), key


def test_recipe_batches_match_jax(manifests, tokenizers):
    port_tok, jax_tok, _ = tokenizers
    port = _loaders(recipe, _hparams(manifests, "port"), port_tok)
    want = _loaders(jax_recipe, _hparams(manifests, "jax"), jax_tok)
    assert port[2].keys() == want[2].keys() == {SPLIT}
    _assert_batches_equal(_batches(port[0]), _batches(want[0]))  # train: shuffled by seed + epoch
    _assert_batches_equal(_batches(port[1]), _batches(want[1]))
    _assert_batches_equal(_batches(port[2][SPLIT]), _batches(want[2][SPLIT]))
    assert port[0].batch_size == 4 and port[0].drop_last and port[0].shuffle
    shapes = {b.sig[0].shape[1] for b in _batches(port[0])}
    assert all((n // 160 + 1) % 36 == 0 for n in shapes)  # fbank frames: a multiple of 36


def test_resume_mid_epoch_matches_jax(manifests, tokenizers):
    """A ``state_dict`` taken at the second train batch, loaded into fresh loaders:
    the rest of the epoch, and the next, as the JAX package's loaders give them."""
    port_tok, jax_tok, _ = tokenizers
    runs = []
    for module, name, tok in ((recipe, "port", port_tok), (jax_recipe, "jax", jax_tok)):
        train = _loaders(module, _hparams(manifests, name), tok)[0]
        train.set_epoch(3)
        it = iter(train)
        next(it)
        next(it)
        state = train.state_dict()
        fresh = _loaders(module, _hparams(manifests, name), tok)[0]
        fresh.load_state_dict(state)
        runs.append(list(fresh) + _batches(fresh, epochs=(4,)))
    assert state == {"position": 1, "epoch": 3}
    _assert_batches_equal(*runs)


def test_prefetch_gives_the_same_batches(manifests, tokenizers):
    port_tok, jax_tok, _ = tokenizers
    plain = _loaders(recipe, _hparams(manifests, "port"), port_tok)[0]
    prefetched = _loaders(recipe, _hparams(manifests, "port", prefetch_batches=2, loader_threads=2), port_tok)[0]
    jax_prefetched = _loaders(jax_recipe, _hparams(manifests, "jax", prefetch_batches=2, loader_threads=2),
                              jax_tok)[0]
    assert isinstance(prefetched, PrefetchLoader) and isinstance(jax_prefetched, JaxPrefetchLoader)
    _assert_batches_equal(_batches(prefetched), _batches(plain))
    _assert_batches_equal(_batches(prefetched), _batches(jax_prefetched))


# -- tokenizer, label encoder, synthetic corpus ------------------------------------------


def test_tokenizer_matches_jax(tokenizers, tmp_path):
    port_tok, jax_tok, lines = tokenizers
    assert port_tok.pieces == jax_tok.pieces and port_tok.log_probs == jax_tok.log_probs
    assert port_tok._native is not None and jax_tok._native is not None
    sentences = lines[:6] + ["HELLO UNSEEN QZX", ""]
    python_tok = UnigramTokenizer().train(lines, vocab_size=40)
    python_tok._native = None
    for s in sentences:
        ids = port_tok.encode_as_ids(s)
        assert ids == jax_tok.encode_as_ids(s) == python_tok.encode_as_ids(s), s
        assert port_tok.decode_ids(ids) == jax_tok.decode_ids(ids), s
    port_tok.save(str(tmp_path / "a.json"))
    jax_tok.save(str(tmp_path / "b.json"))
    assert filecmp.cmp(tmp_path / "a.json", tmp_path / "b.json", shallow=False)
    loaded = UnigramTokenizer().Load(str(tmp_path / "b.json"))
    assert loaded.pieces == jax_tok.pieces and loaded.encode_as_ids(lines[0]) == jax_tok.encode_as_ids(lines[0])


def test_load_sentencepiece_matches_jax(tmp_path):
    path = tmp_path / "tok.model"
    path.write_bytes(_model_bytes(ENTRIES))
    port_tok = UnigramTokenizer().load_sentencepiece(str(path))
    jax_tok = JaxTokenizer().load_sentencepiece(str(path))
    assert port_tok.pieces == jax_tok.pieces and port_tok.log_probs == jax_tok.log_probs
    assert port_tok._control_ids == jax_tok._control_ids
    for s in ("THE CAT", "THE HAT CAT", "XYZ"):
        ids = port_tok.encode_as_ids(s)
        assert ids == jax_tok.encode_as_ids(s) and port_tok.decode_ids(ids) == jax_tok.decode_ids(ids)


def test_label_encoder_file_matches_jax(tmp_path):
    port_enc, jax_enc = CategoricalEncoder(), JaxEncoder()
    for enc in (port_enc, jax_enc):
        enc.update_from_iterable(["M", "F", "M"])
    port_enc.save(str(tmp_path / "a.txt"))
    jax_enc.save(str(tmp_path / "b.txt"))
    assert filecmp.cmp(tmp_path / "a.txt", tmp_path / "b.txt", shallow=False)
    back = CategoricalEncoder()
    back.load(str(tmp_path / "b.txt"))
    assert back.lab2ind == jax_enc.lab2ind


def test_build_corpus_bytes_match(tmp_path):
    got = synth.build_corpus(str(tmp_path / "p"), n_train_spk=1, n_test_spk=1, utts=1, words_per_utt=2, seed=4)
    want = jax_synth.build_corpus(str(tmp_path / "j"), n_train_spk=1, n_test_spk=1, utts=1, words_per_utt=2,
                                  seed=4)
    assert got == want
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert sum(f.endswith(".wav") for f in files) == 4
    for f in files:
        assert filecmp.cmp(tmp_path / "p" / f, tmp_path / "j" / f, shallow=False), f

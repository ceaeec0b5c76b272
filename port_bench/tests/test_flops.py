"""The FLOP counts pinned to ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference's forward at a small size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, seeded
from port_bench.reference import frontend, models

C = dict(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2, d_ffn=64, vocab=50,
         lm_d_model=32, lm_nhead=4, lm_num_layers=2, lm_d_ffn=64)
B, SAMPLES = 2, 71 * 160
T = flops.frames(SAMPLES)


def counted(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def weights(module):
    return seeded.draw_weights(module, 1, 1, "cpu")


@pytest.fixture(scope="module")
def nets():
    from speech_anonymization_tpu_torch.models.asr import ASRModel
    from speech_anonymization_tpu_torch.models.autoencoders import ConvAutoencoder
    from speech_anonymization_tpu_torch.models.transformer import TransformerLM
    from speech_anonymization_tpu_torch.models.xvector import Xvector, XvectorClassifier

    asr = ASRModel(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2, d_ffn=64, output_neurons=50,
                   device="cpu")
    return {"ae": weights(ConvAutoencoder(device="cpu")), "emb": weights(Xvector(device="cpu")),
            "clf": weights(XvectorClassifier(device="cpu")), "asr": weights(asr),
            "lm": weights(TransformerLM(vocab=50, d_model=32, nhead=4, num_layers=2, d_ffn=64, device="cpu"))}


def test_fbank():
    wavs = torch.randn(B, SAMPLES)
    assert counted(frontend.fbank, wavs) == flops.fbank(B, SAMPLES)


def test_autoencoder_and_head(nets):
    x = torch.randn(B, 72, 80)
    assert counted(models.anonymize, nets["ae"], x) == flops.ae_encode(B, 72) + flops.ae_decode(B, 72)
    assert counted(models.autoencoder, nets["ae"], x) == (flops.ae_encode(B, 72) + flops.ae_decode(B, 72)
                                                          + flops.sex_head(B, 72))


def test_xvector(nets):
    x = torch.randn(B, T, 80)
    assert counted(models.xvector_log_probs, nets["emb"], nets["clf"], x) == flops.xvector(B, T)


def test_asr_encoder_and_decoder(nets):
    x, lens = torch.randn(B, T, 80), torch.ones(B)
    assert counted(models.asr_encode, nets["asr"], x, lens, 4) == flops.asr_encode(B, T, C)
    enc = models.asr_encode(nets["asr"], x, lens, 4)
    tokens = torch.randint(3, 50, (B, 11))
    te = flops.enc_frames(T)

    def dec():
        models.seq_logits(nets["asr"], models.asr_decode(nets["asr"], tokens, enc, lens, 4))

    assert counted(dec) == flops.asr_decode(B, 11, te, C)


def test_lm(nets):
    tokens = torch.randint(3, 50, (B, 13))
    assert counted(models.lm_logits, nets["lm"], tokens, 4) == flops.lm_forward(B, 13, C)


def test_decode_step_sums_to_the_teacher_forced_decoder():
    """A step's decoder and LM products over step + 1 positions, summed over
    steps, are the teacher-forced forward's less its masked half of the
    self-attention and the cross K/V (made once a decode)."""
    n, u, te, m = 3, 9, 7, C["d_model"]
    steps = sum(flops.decode_step(n, s, te, {**C}, True) - 2 * n * te * C["vocab"] for s in range(u))
    tf = flops.asr_decode(n, u, te, C) + flops.lm_forward(n, u, C)
    masked_half = ((C["num_decoder_layers"] * flops.attention(n, u, u, m) + C["lm_num_layers"]
                    * flops.attention(n, u, u, C["lm_d_model"])) - (C["num_decoder_layers"] + C["lm_num_layers"])
                   * sum(flops.attention(n, 1, s + 1, m) for s in range(u)))
    cross_kv = C["num_decoder_layers"] * 2 * flops.linear(n * te, m, m)
    assert steps == tf - masked_half - cross_kv

"""The seeded inputs: the same seed gives the same inputs, another seed others."""

import pytest
import torch

from port_bench import seeded

SEEDS = (0, 2**31 + 17, 5_000_000_123)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(seed):
    a = seeded.waveforms(2, 4000, seed, 100, "cpu")
    assert torch.equal(a, seeded.waveforms(2, 4000, seed, 100, "cpu"))
    assert torch.equal(seeded.ints((3, 5), 3, 64, seed, 7, "cpu"), seeded.ints((3, 5), 3, 64, seed, 7, "cpu"))
    aug = {"time_warp_window": 5, "n_freq_mask": 2, "freq_mask_width": 30, "n_time_mask": 2, "time_mask_width": 40}
    d1, d2 = (seeded.spec_augment_draws(4, 72, 80, seed, 9, aug) for _ in range(2))
    assert d1[0] == d2[0] and all(torch.equal(x, y) for x, y in zip(d1[1] + d1[2], d2[1] + d2[2]))
    assert float(a.abs().max()) == pytest.approx(0.5)


def test_other_seed_other_inputs():
    a, b = (seeded.waveforms(2, 4000, s, 100, "cpu") for s in SEEDS[:2])
    assert not torch.equal(a, b)
    assert not torch.equal(seeded.waveforms(2, 4000, 1, 100, "cpu"), seeded.waveforms(2, 4000, 1, 101, "cpu"))


def test_weights_drawn_into_the_module():
    from speech_anonymization_tpu_torch.models.autoencoders import ConvAutoencoder

    ae = ConvAutoencoder(device="cpu")
    w = seeded.draw_weights(ae, 3, 1, "cpu")
    again = seeded.draw_weights(ConvAutoencoder(device="cpu"), 3, 1, "cpu")
    for k, v in ae.state_dict().items():
        if k in w:
            assert torch.equal(v, w[k]) and torch.equal(w[k], again[k])
    assert float(w["sex_classifier.norms.0.running_var"].min()) > 0

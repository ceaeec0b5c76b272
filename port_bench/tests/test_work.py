"""The frozen work counters against the smoke run's own functions
(``chip_smoke.py``) at the cells' shapes."""

import types

import pytest
import torch

from port_bench import work

chip_smoke = pytest.importorskip("chip_smoke")


@pytest.mark.parametrize("rows", [32 * 1008, 8 * 1008, 8 * 504])
def test_k1(rows, monkeypatch):
    from speech_anonymization_tpu_torch.ops.fbank import Fbank

    captured = {}
    real = chip_smoke.kernel_entry

    def entry(name, max_abs_err, ms, plain_ms, flops, nbytes, library_ms, tc_flops=0.0, tf32_flops=0.0):
        captured.update(flops=flops, nbytes=nbytes, tf32=tf32_flops)
        return real(name, max_abs_err, ms, plain_ms, flops, nbytes, library_ms, tc_flops, tf32_flops)

    monkeypatch.setattr(chip_smoke, "kernel_entry", entry)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda *a, **k: 1.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    chip_smoke.k1_measure(torch.zeros(rows, 1, 400), Fbank(device="cpu"))
    mine = work.k1_work(rows)
    assert (mine["flops"], mine["tf32_flops"], mine["bytes"]) == (captured["flops"], captured["tf32"],
                                                                    captured["nbytes"])


def _beam_cache(n, u, page, m, steps, gen):
    """A paged cache's table and parents after a simulated beam history."""
    up = u // page
    table = torch.arange(n, dtype=torch.int32)[:, None].repeat(1, up)
    act = torch.arange(n, dtype=torch.int32)
    for s in range(steps):
        src = torch.randint(0, n, (n,), generator=gen, dtype=torch.int32)
        table = table.index_select(0, src)
        if s % page == page - 1:
            table[:, s // page] = src
        act = src
    return table, act


@pytest.mark.parametrize("n,u,page,m,step,layers", [(528, 256, 64, 768, 125, 12), (528, 256, 64, 768, 251, 6),
                                                     (528, 128, 32, 768, 63, 12), (528, 128, 32, 768, 100, 6)])
def test_paged_bytes_and_k7(n, u, page, m, step, layers):
    gen = torch.Generator().manual_seed(step)
    table, act = _beam_cache(n, u, page, m, step, gen)
    mask = torch.zeros(n, u, dtype=torch.bool)
    mask[:, :step + 1] = True
    mask[torch.rand(n, u, generator=gen) < 0.05] = False
    cache = {"table": table, "act_src": act, "tokens": torch.zeros(n, u, dtype=torch.long),
             "kv": torch.empty(layers, n, 2 * u, m, device="meta"),
             "kv_act": torch.empty(layers, n, 2, 2 * page, m, device="meta")}
    cache_bytes = work.paged_cache_bytes(table, act, mask, step, u, m, 4)
    assert cache_bytes == chip_smoke._paged_cache_bytes(cache, mask, step, 4)
    assert work.mask_table_bytes(n, u // page, u, step) == chip_smoke._mask_table_bytes(cache, step)
    k6 = work.paged_attention_work(table, mask, step, u, m, 8, cache_bytes)
    assert k6["bytes"] == chip_smoke._paged_bytes(cache, mask, step, 4)
    assert k6["flops"] == 4 * int(mask[:, :step + 1].sum()) * (m // 8) * 8 + n * 8 * (step + 1)
    lm = types.SimpleNamespace(nhead=12, num_layers=layers, d_ffn=3072, d_model=m)
    wall = torch.empty(layers * (4 * m * m + 2 * m * 3072), device="meta")
    vecs = torch.empty(layers * (9 * m + 3072), device="meta")
    x0 = torch.empty(n, m, device="meta")
    want = chip_smoke._k7_work(lm, wall, vecs, x0, mask, cache, step)
    got = work.k7_work(table, mask, step, u, m, 12, layers, 3072, cache_bytes)
    assert (got["flops"], got["tc_flops"], got["bytes"]) == want


def test_k7_stacked_weights_sizes():
    from speech_anonymization_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(vocab=40, d_model=64, nhead=4, num_layers=2, d_ffn=128, device="cpu")
    wall, vecs = lm.prepare_megastep()
    assert wall.numel() == 2 * (4 * 64 * 64 + 2 * 64 * 128)
    assert vecs.numel() == 2 * (9 * 64 + 128)

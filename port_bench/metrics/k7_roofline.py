"""K7's share of its roofline over the recorded window's launches: the least
time their operations and bytes need over their device time. K7 is the LM's
whole decode step in one launch (``lm_mega`` in ``csrc/lm_megastep.cu``),
entered through ``lm_megastep`` in ``models/transformer.py``."""

import re

from port_bench import work
from port_bench.readers import roofline

KERNEL = re.compile(r"\blm_mega<")
ENTRY = "speech_anonymization_tpu_torch.models.transformer:lm_megastep"


def keep(x0, mask, cache_kv, act_kv, table, act_src, step, wall, vecs, nhead, **kw):
    return (mask, table, act_src, step, mask.shape[1], x0.shape[1], nhead, cache_kv.element_size(),
            cache_kv.shape[0])


def work_of(kept: list, cfg: dict) -> list:
    memo: dict = {}
    return [work.k7_work(table, mask, step, u, m, nhead, layers, cfg["lm_d_ffn"],
                         work.paged_bytes_memo(memo, table, act_src, mask, step, u, m, itemsize))
            for mask, table, act_src, step, u, m, nhead, itemsize, layers in kept]


def read(run):
    return roofline(run, "k7_roofline", KERNEL)

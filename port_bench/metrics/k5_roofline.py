"""K5's share of its roofline over the recorded window's launches: the least
time their operations and bytes need over their device time. K5 is the
whole-row paged attention step of float32 and bfloat16 caches
(``attn_step_paged_rows`` in ``csrc/attention_step.cu``), entered through
``cached_attention_step_paged`` in ``models/transformer.py``."""

import re

from port_bench import work
from port_bench.readers import roofline

KERNEL = re.compile(r"\battn_step_paged_rows<")
ENTRY = "speech_anonymization_tpu_torch.models.transformer:cached_attention_step_paged"


def keep(q, kh, vh, mask, cache, step, layer, nhead):
    return work.paged_launch(mask, cache, step, nhead, chunked=False)


def work_of(kept: list, cfg: dict) -> list:
    return work.paged_launches_work(kept)


def read(run):
    return roofline(run, "k5_roofline", KERNEL)

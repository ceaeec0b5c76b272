"""K6's share of its roofline over the recorded window's launches: the least
time their operations and bytes need over their device time. K6 is the
chunked paged attention step of float32 and bfloat16 caches
(``attn_step_chunked<T, true>`` in ``csrc/attention_step.cu``; K4 is its
unpaged twin, the int8 kernels are others), entered through
``cached_attention_step_paged`` in ``models/transformer.py``."""

import re

from port_bench import work
from port_bench.readers import roofline

KERNEL = re.compile(r"\battn_step_chunked<[^<>,]+, true>")
ENTRY = "speech_anonymization_tpu_torch.models.transformer:cached_attention_step_paged"


def keep(q, kh, vh, mask, cache, step, layer, nhead):
    return work.paged_launch(mask, cache, step, nhead, chunked=True)


def work_of(kept: list, cfg: dict) -> list:
    return work.paged_launches_work(kept)


def read(run):
    return roofline(run, "k6_roofline", KERNEL)

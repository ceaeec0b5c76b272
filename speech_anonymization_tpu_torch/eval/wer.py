"""Word-error-rate metric with full alignment reports (numpy; ``append`` is a span).

The port's own copy of ``speech_anonymization_tpu/eval/wer.py``.

Replaces speechbrain.utils.metric_stats.ErrorRateStats (wired as
error_rate_computer at convae.yaml:297, consumed at
speechbrain_convae_train.py:182-183,350-351). ``write_stats`` emits the
same report format as the reference's wer_*.txt artifacts
(results/1_5_endtoend/8886/wer_test-clean-100.txt): a ``%WER`` header with
ins/del/sub counts, ``%SER``, and per-utterance ``;``-aligned
ref/ops/hyp triples with ``<eps>`` gaps.
"""

from __future__ import annotations

import numpy as np

from ..utils.profiler import span

EPS_TOKEN = "<eps>"


def edit_distance_details(ref: list[str], hyp: list[str]):
    """Levenshtein alignment. Returns (n_ins, n_del, n_sub, alignment)
    where alignment is a list of (op, ref_tok|None, hyp_tok|None),
    op in {'=', 'S', 'I', 'D'}."""
    n, m = len(ref), len(hyp)
    dist = np.zeros((n + 1, m + 1), np.int32)
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dist[i, j] = min(sub, dist[i - 1, j] + 1, dist[i, j - 1] + 1)
    # backtrace
    i, j = n, m
    alignment = []
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            op = "=" if ref[i - 1] == hyp[j - 1] else "S"
            alignment.append((op, ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and dist[i, j] == dist[i - 1, j] + 1:
            alignment.append(("D", ref[i - 1], None))
            i -= 1
        else:
            alignment.append(("I", None, hyp[j - 1]))
            j -= 1
    alignment.reverse()
    n_ins = sum(1 for op, _, _ in alignment if op == "I")
    n_del = sum(1 for op, _, _ in alignment if op == "D")
    n_sub = sum(1 for op, _, _ in alignment if op == "S")
    return n_ins, n_del, n_sub, alignment


class ErrorRateStats:
    def __init__(self):
        self.clear()

    def clear(self):
        self.utts = []  # (id, ref, hyp, ins, del, sub)

    def append(self, ids, predicted, targets):
        """ids: list[str]; predicted/targets: list[list[str]] word lists."""
        with span("eval.wer"):
            for utt_id, hyp, ref in zip(ids, predicted, targets):
                hyp = [w for w in hyp if w]
                ref = [w for w in ref if w]
                ni, nd, ns, ali = edit_distance_details(ref, hyp)
                self.utts.append(
                    {"id": utt_id, "ref": ref, "hyp": hyp, "ins": ni, "del": nd,
                     "sub": ns, "alignment": ali}
                )

    def summarize(self, field: str | None = None):
        total_ref = sum(len(u["ref"]) for u in self.utts)
        total_err = sum(u["ins"] + u["del"] + u["sub"] for u in self.utts)
        n_sent = len(self.utts)
        n_err_sent = sum(1 for u in self.utts if u["ins"] + u["del"] + u["sub"] > 0)
        summary = {
            "error_rate": 100.0 * total_err / max(total_ref, 1),
            "WER": 100.0 * total_err / max(total_ref, 1),
            "SER": 100.0 * n_err_sent / max(n_sent, 1),
            "insertions": sum(u["ins"] for u in self.utts),
            "deletions": sum(u["del"] for u in self.utts),
            "substitutions": sum(u["sub"] for u in self.utts),
            "num_ref_tokens": total_ref,
            "num_sentences": n_sent,
            "num_erroneous_sents": n_err_sent,
        }
        if field is not None:
            return summary[field]
        return summary

    # -- report ---------------------------------------------------------------

    @staticmethod
    def _aligned_rows(alignment):
        refs, ops, hyps = [], [], []
        for op, r, h in alignment:
            refs.append(r if r is not None else EPS_TOKEN)
            ops.append(op if op != "=" else "=")
            hyps.append(h if h is not None else EPS_TOKEN)
        widths = [max(len(a), len(b), len(c)) for a, b, c in zip(refs, ops, hyps)]
        fmt = lambda toks: " ; ".join(t.center(w) for t, w in zip(toks, widths))
        return fmt(refs), fmt(ops), fmt(hyps)

    def write_stats(self, fileobj):
        s = self.summarize()
        err = s["insertions"] + s["deletions"] + s["substitutions"]
        fileobj.write(
            f"%WER {s['WER']:.2f} [ {err} / {s['num_ref_tokens']}, "
            f"{s['insertions']} ins, {s['deletions']} del, {s['substitutions']} sub ]\n"
        )
        fileobj.write(
            f"%SER {s['SER']:.2f} [ {s['num_erroneous_sents']} / {s['num_sentences']} ]\n"
        )
        fileobj.write(f"Scored {s['num_sentences']} sentences, 0 not present in hyp.\n")
        fileobj.write("=" * 80 + "\nALIGNMENTS\n\nFormat:\n<utterance-id>, WER DETAILS\n")
        for u in self.utts:
            n_err = u["ins"] + u["del"] + u["sub"]
            wer = 100.0 * n_err / max(len(u["ref"]), 1)
            fileobj.write("=" * 80 + "\n")
            fileobj.write(
                f"{u['id']}, %WER {wer:.2f} [ {n_err} / {len(u['ref'])}, "
                f"{u['ins']} ins, {u['del']} del, {u['sub']} sub ]\n"
            )
            r, o, h = self._aligned_rows(u["alignment"])
            fileobj.write(r + "\n" + o + "\n" + h + "\n")

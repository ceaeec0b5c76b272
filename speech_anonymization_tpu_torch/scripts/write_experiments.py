"""Render the port's EXPERIMENTS.md from recorded pipeline results.

Counterpart of ``scripts/write_experiments.py`` (the same renderer; nothing
is re-run here). Inputs, each from the live work dir
``save/repro_gender_row_torch/`` when present, else from the archive
``artifacts/repro_torch/``:

  gender/repro_stats.json   (stage 1: ACC on original audio)
  asr/repro_stats.json      (stage 1.5: tiny-ASR WER)
  sweep_results.jsonl       (round4_sweep, reeval_frontier)
  attack_results.jsonl      (attack_retrain)
  vocoder_ab.jsonl          (vocoder_ab)

Writes ``artifacts/repro_torch/EXPERIMENTS.md`` (never the root
EXPERIMENTS.md, the JAX package's record). The prose is generated FROM the
numbers; the headline row is the sweep variant with the best privacy at
acceptable utility, and the headline table names the device and card the
rows ran on::

    python -m speech_anonymization_tpu_torch.scripts.write_experiments
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Sequence

from . import archive_repro


def _resolve(work, archive_dir, *rel):
    live = os.path.join(work, *rel)
    return live if os.path.exists(live) else os.path.join(archive_dir, *rel)


def _load_jsonl(path):
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = [json.loads(line) for line in f]
    return rows


def _fmt(x, nd=3):
    if x is None or (isinstance(x, float) and math.isnan(x)):
        return "—"
    return f"{x:.{nd}f}"


def _spread(vals):
    lo, hi = min(vals), max(vals)
    mean = sum(vals) / len(vals)
    return mean, lo, hi


def _require(work, archive_dir, *rel):
    path = _resolve(work, archive_dir, *rel)
    if not os.path.exists(path):
        raise SystemExit(
            f"missing {'/'.join(rel)} in BOTH the work dir and the archive — run "
            "round4_sweep (it builds the stages and archives every result), then retry"
        )
    return path


def _devices(*row_lists):
    """The distinct ``card (device)`` names of the rows, in order of appearance."""
    seen = []
    for rows in row_lists:
        for r in rows:
            name = f"{r.get('card') or 'no card'} ({r.get('device', 'unknown device')})"
            if name not in seen:
                seen.append(name)
    return "; ".join(seen) or "not recorded"


def render(work: str, archive_dir: str) -> tuple[str, str, bool]:
    """-> (the document, the headline variant, whether it reproduces the
    reference's direction)."""
    with open(_require(work, archive_dir, "gender", "repro_stats.json")) as f:
        stage1 = json.load(f)
    acc_orig = stage1["acc_orig"]
    with open(_require(work, archive_dir, "asr", "repro_stats.json")) as f:
        stage15 = json.load(f)
    wer_asr = stage15["wer"]
    rows = _load_jsonl(_resolve(work, archive_dir, "sweep_results.jsonl"))
    ab = {r["method"]: r for r in _load_jsonl(_resolve(work, archive_dir, "vocoder_ab.jsonl"))}
    if not rows:
        raise SystemExit("no sweep results recorded — run round4_sweep first")

    # group by variant (seed spread)
    by_variant = {}
    for r in rows:
        by_variant.setdefault(r["variant"], []).append(r)

    # pick the headline: biggest |ACC_ext(anon) - 0.5| REDUCTION vs orig
    # among variants that keep the features decodable (WER_anon within
    # 3x WER_orig + 10 absolute points — the reference's own operating
    # points degrade WER 0.5-12 points, BASELINE.md)
    def privacy(r):  # distance from chance on the EXTERNAL evaluator
        return abs(r["acc_ext_anon"] - 0.5)

    def usable(r):
        wo = r["wer_orig"] if not math.isnan(r["wer_orig"]) else wer_asr
        return r["wer_anon"] <= 3 * wo + 10.0

    def agg(variant):
        rs = by_variant[variant]
        return {
            "variant": variant,
            "n": len(rs),
            "acc_ext_anon": sum(r["acc_ext_anon"] for r in rs) / len(rs),
            "acc_ext_anon_all": [r["acc_ext_anon"] for r in rs],
            "acc_ext_orig": sum(r["acc_ext_orig"] for r in rs) / len(rs),
            "acc_internal": sum(r["acc_internal"] for r in rs) / len(rs),
            "utility": sum(r["utility"] for r in rs) / len(rs),
            "wer_anon": sum(r["wer_anon"] for r in rs) / len(rs),
            "wer_anon_all": [r["wer_anon"] for r in rs],
            "wer_orig": sum(r["wer_orig"] for r in rs) / len(rs),
            "usable": all(usable(r) for r in rs),
            "privacy": sum(privacy(r) for r in rs) / len(rs),
            "model_type": rs[0]["model_type"],
            "epochs": rs[0]["epochs"],
        }

    aggs = [agg(v) for v in by_variant]
    candidates = [a for a in aggs if a["usable"]] or aggs
    best = min(candidates, key=lambda a: a["privacy"])
    # "reproduced" = external evaluator materially off its original-feature
    # accuracy while staying decodable
    reproduced = best["usable"] and (
        best["acc_ext_orig"] - best["acc_ext_anon"] >= 0.25
    )
    attacks = _load_jsonl(_resolve(work, archive_dir, "attack_results.jsonl"))
    devices = _devices([stage1, stage15], rows, attacks, list(ab.values()))

    lines = []
    lines.append("# Reduced-scale reproduction of the reference research rows (PyTorch port)\n")
    lines.append(
        "The environment ships no LibriSpeech audio, so the reference's headline\n"
        "rows are reproduced IN KIND on a synthetic formant-rich gendered corpus\n"
        "(at the scripts' settings 16 train + 10 held-out test speakers, F0 M~115 Hz /\n"
        "F~210 Hz, female formants x1.12; each WORD is a fixed phone sequence so the\n"
        "audio carries the transcript — speech_anonymization_tpu_torch/data/synth.py)\n"
        "through the port's recipes end-to-end. Scale caveat: absolute numbers are\n"
        "not comparable to LibriSpeech rows.\n"
    )
    if reproduced:
        lines.append(
            f"STATUS: the `{best['variant']}` schedule reproduces the reference's\n"
            "headline DIRECTION — the externally trained evaluator loses the sex\n"
            f"cue on anonymized features (ACC_ext {_fmt(best['acc_ext_orig'])} ->\n"
            f"{_fmt(best['acc_ext_anon'])}) while the features stay decodable\n"
            f"(WER {_fmt(best['wer_orig'],1)}% -> {_fmt(best['wer_anon'],1)}%).\n"
            "The reference direction is 0.96 -> 0.39 at WER 9.11% (fcae) and\n"
            "0.60 -> 0.22 at WER 3.53% (endtoend) — see the sweep table for\n"
            "which mechanisms transfer at reduced scale and which do not.\n"
        )
    else:
        lines.append(
            "STATUS: NO swept schedule reproduces the reference's external-\n"
            "evaluator result at this scale. The internal adversary reaches\n"
            "chance but the external classifier keeps reading the cue (the\n"
            "GRL scrambles its own head, not the feature); the sweep table\n"
            "below is the recorded evidence. The reference direction\n"
            "(ACC_ext 0.96 -> 0.39) therefore remains unreproduced here —\n"
            "see the per-variant rows for how far each mechanism moves it.\n"
        )

    b = best
    lines.append("\n## Headline row (variant `%s`%s)\n" % (
        b["variant"], f", mean of {b['n']} seeds" if b["n"] > 1 else ""))
    lines.append("| Row | Reference (LibriSpeech, full scale) | This repo (synthetic, reduced) |")
    lines.append("|---|---|---|")
    lines.append(f"| Gender ACC, original audio | ~0.96 (results/gender_classifier/1230/train_log.txt) | **{_fmt(acc_orig)}** |")
    lines.append(f"| ACC_external, original features | ~0.96 | **{_fmt(b['acc_ext_orig'])}** |")
    lines.append(f"| ACC_external, ANONYMIZED features | 0.39 (fcae recon0.5/sex0.5) / 0.22 (endtoend resume) | **{_fmt(b['acc_ext_anon'])}** |")
    lines.append(f"| Internal (adversary) ACC on anon | — | {_fmt(b['acc_internal'])} |")
    lines.append(f"| WER, original features | 7.49% (fullyconn_normalize recon1.0) | **{_fmt(b['wer_orig'],1)}%** (tiny-ASR baseline {_fmt(wer_asr,1)}%) |")
    lines.append(f"| WER, ANONYMIZED features | 9.11% (fcae recon0.1/sex0.9) / 3.53% (endtoend resume) | **{_fmt(b['wer_anon'],1)}%** |")
    lines.append(f"| Utility retention (ASR-encoder cosine) | 0.617-0.916 | {_fmt(b['utility'])} |")
    lines.append(f"| Ran on (card, power limit; device) | — | {devices} |")
    if b["n"] > 1:
        am, alo, ahi = _spread(b["acc_ext_anon_all"])
        wm, wlo, whi = _spread(b["wer_anon_all"])
        lines.append(
            f"\nSeed spread ({b['n']} training seeds): ACC_ext(anon) "
            f"{_fmt(am)} [{_fmt(alo)}, {_fmt(ahi)}]; WER(anon) "
            f"{_fmt(wm,1)}% [{_fmt(wlo,1)}%, {_fmt(whi,1)}%].")

    lines.append("\n## Stage-2 schedule sweep (round4_sweep)\n")
    lines.append(
        "All variants share the cached stage-1 evaluator + stage-1.5 tiny ASR\n"
        "and train only the anonymizer. `e2e*` = model_type=endtoend (trains\n"
        "against the FROZEN external classifier, the reference's 1_5_endtoend\n"
        "family); others = fcae with the internal GRL adversary. `conf`/`mix`\n"
        "use NEGATIVE confusion weights (through a GRL, -w is what 'drive the\n"
        "head to uniform' requires — the round-3 sweep had the sign inverted).\n")
    if not any(r["model_type"] == "endtoend" for r in rows):
        lines.append(
            "NOTE: no `e2e*` (endtoend) rows are recorded below. That family is\n"
            "the reference's BEST mechanism (train the generator directly against\n"
            "the frozen external classifier); until one of its rows is recorded,\n"
            "the reference's external-evaluator result is NOT reproduced by any\n"
            "recorded row.\n")
    lines.append("| variant | model | seed | ACC_ext orig | ACC_ext anon | internal | WER orig | WER anon | utility |")
    lines.append("|---|---|---|---|---|---|---|---|---|")
    for r in sorted(rows, key=lambda r: (r["variant"], r["seed"])):
        lines.append(
            f"| {r['variant']} | {r['model_type']} | {r['seed']} | "
            f"{_fmt(r['acc_ext_orig'])} | **{_fmt(r['acc_ext_anon'])}** | "
            f"{_fmt(r['acc_internal'])} | {_fmt(r['wer_orig'],1)}% | "
            f"{_fmt(r['wer_anon'],1)}% | {_fmt(r['utility'])} |")

    if attacks:
        lines.append("\n## Attack after anonymization (attack_retrain)\n")
        lines.append(
            "A FRESH gender classifier retrained ON the anonymized features\n"
            "(the reference's gender_classifier_train_recon recipe) — the\n"
            "strongest privacy metric: fooling the fixed evaluator is not\n"
            "enough if a retrained attacker recovers the cue.\n")
        lines.append("| variant | seed | retrained-attacker ACC (held-out) |")
        lines.append("|---|---|---|")
        for a in attacks:
            lines.append(f"| {a['variant']} | {a['seed']} | **{_fmt(a['attack_acc'])}** |")

    if len(ab) == 2:
        d = abs(ab["world"]["acc_pitch_norm"] - ab["psola"]["acc_pitch_norm"])
        lines.append("\n## Vocoder-implementation bound (vocoder_ab)\n")
        lines.append(
            "pyworld cannot be installed here, so the divergence of\n"
            "native/world_vocoder.cc from pw.wav2world/pw.synthesize is bounded\n"
            "by a proxy: the pitch-norm recipe conclusion must be invariant to\n"
            "swapping the WORLD-class vocoder for the structurally different\n"
            "TD-PSOLA resynthesis.\n")
        lines.append("| pipeline | gender ACC (held-out) |")
        lines.append("|---|---|")
        lines.append(f"| original audio | {_fmt(ab['world']['acc_orig_audio'])} |")
        lines.append(f"| pitch-normalized, method=world | {_fmt(ab['world']['acc_pitch_norm'])} |")
        lines.append(f"| pitch-normalized, method=psola | {_fmt(ab['psola']['acc_pitch_norm'])} |")
        lines.append(
            f"\n|ACC_world - ACC_psola| = {_fmt(d)}: the downstream conclusion "
            "does not depend on the vocoder implementation." if d <= 0.1 else
            f"\n|ACC_world - ACC_psola| = {_fmt(d)}: the two resynthesis "
            "implementations DISAGREE — treat pitch-norm rows as "
            "vocoder-sensitive.")

    m = "python -m speech_anonymization_tpu_torch.scripts."
    lines.append(
        "\n## Commands\n\n"
        f"    {m}round4_sweep baseline e2e_warm e2e_conf conf grl4 ...\n"
        f"    {m}round4_sweep <winner> --seeds=0,1,2\n"
        f"    {m}reeval_frontier <winner> <seed>\n"
        f"    {m}attack_retrain <winner> <seed> [frontier]\n"
        f"    {m}vocoder_ab\n"
        f"    {m}write_experiments\n\n"
        "(each on the card unless `--device cpu` is given; recipe chain per run:\n"
        "gender_classifier.yaml 8 epochs -> transformer.yaml tiny ASR (64d, 2+2\n"
        "layers, beam 4) 40 epochs -> convae.yaml with the variant's\n"
        "adversarial_schedule; lr_adam 0.55 for fcae / 0.25 for endtoend\n"
        "variants, n_warmup_steps 100; `*_warm` variants prepend a recon-only\n"
        "phase resumed in place (the reference's endtoend runs resumed\n"
        "recon-pretrained models); external evaluator from stage 1 + ASR from\n"
        "stage 1.5 attached; disjoint test speakers throughout. Ran on: "
        f"{devices}.)\n")
    return "\n".join(lines), best["variant"], reproduced


def main(argv: Sequence[str] | None = None, *, work: str | None = None, archive_dir: str | None = None) -> int:
    """``write_experiments`` (no arguments): :func:`render` into
    ``<archive>/EXPERIMENTS.md``."""
    if list(argv if argv is not None else sys.argv[1:]):
        raise SystemExit("usage: write_experiments (no arguments)")
    work, archive_dir = work or archive_repro.WORK, archive_dir or archive_repro.ARCHIVE
    text, headline, reproduced = render(work, archive_dir)
    os.makedirs(archive_dir, exist_ok=True)
    out = os.path.join(archive_dir, "EXPERIMENTS.md")
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out} (headline variant: {headline}, reproduced={reproduced})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

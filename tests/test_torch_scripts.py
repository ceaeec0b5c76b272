"""The port's research pipeline (``speech_anonymization_tpu_torch/scripts/``)
against the JAX package's ``scripts/`` on the CPU:

  * orchestration: each JAX script is imported as a module from ``scripts/``;
    the recipes' ``main`` of BOTH packages is replaced by a recorder that
    returns a fake brain with fixed ``test_stats`` (and, under
    ``--eval_ckpt_select valid_frontier``, a ``selected_ckpt_meta``). Each
    script runs through both packages on its own root (every JAX script's
    ``REPO`` and ``archive_repro.WORK``/``ARCHIVE`` point into ``tmp_path``,
    the port's too; ``SPEAKERS.TXT`` is planted so no corpus is built): the
    recipes must be called in the same order with the same argv (less
    ``--device`` and the work dir), and the JSONL rows must be equal key for
    key (less ``wall_s``; the port adds ``device`` and ``card``). The port's
    sweep exits non-zero after a failing variant (the JAX one exits 0); both
    ``reeval_frontier``s abort without the frontier meta;
  * the warm-resume protocol against the JAX recipe: a recon-only epoch, then
    a second ``main()`` in the same folder under another schedule, in both
    packages from one seeded checkpoint: the resumed epoch's losses, the
    kept trees, Noam's step and the counter agree;
  * one real run of the port's pipeline at a tiny size (``build_corpus`` at
    2 + 1 speakers a sex, 3 utterances): the stages, ``conf`` for 2 epochs and
    its frontier re-evaluation, ``e2e_warm`` at 1 warm epoch + 1, the attack,
    and ``write_experiments``.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models import FullyConnectedAutoencoder as JaxFCAE
from speech_anonymization_tpu.recipes import anonymizer as jax_anonymizer
from speech_anonymization_tpu.recipes import asr_train as jax_asr_train
from speech_anonymization_tpu.recipes import gender_classifier as jax_gender
from speech_anonymization_tpu.recipes import gender_classifier_pitch_norm as jax_pitch
from speech_anonymization_tpu_torch.recipes import anonymizer as port_anonymizer
from speech_anonymization_tpu_torch.recipes import asr_train as port_asr_train
from speech_anonymization_tpu_torch.recipes import gender_classifier as port_gender
from speech_anonymization_tpu_torch.recipes import gender_classifier_pitch_norm as port_pitch
from speech_anonymization_tpu_torch.scripts import archive_repro as port_archive
from speech_anonymization_tpu_torch.scripts import attack_retrain as port_attack
from speech_anonymization_tpu_torch.scripts import reeval_frontier as port_reeval
from speech_anonymization_tpu_torch.scripts import repro_gender_row as port_repro
from speech_anonymization_tpu_torch.scripts import round4_sweep as port_sweep
from speech_anonymization_tpu_torch.scripts import vocoder_ab as port_vocoder
from speech_anonymization_tpu_torch.scripts import write_experiments as port_write
from speech_anonymization_tpu_torch.train.checkpoint import Checkpointer, read_tree
from tests.test_torch_recipe_main import _argv, _kept, _losses, _seed_checkpoint
from tests.fixtures import make_fake_librispeech
from tests.torch_port_helpers import random_variables, shape_init

ROOT = Path(__file__).resolve().parents[1]
SCRIPT_NAMES = ("archive_repro", "repro_gender_row", "round4_sweep", "reeval_frontier", "attack_retrain",
                "vocoder_ab", "write_experiments")
# the fake brains' test stats: values with bits below 1e-3, so a rounding shows
GENDER_STATS = {"error": 0.0625}
ASR_STATS = {"WER": 12.34375}
ANON_STATS = {"ACC_external_orig": 0.96875, "ACC_external": 0.59375, "ACC": 0.53125,
              "Utility_Retention": 0.8828125, "WER": 21.6875, "WER_orig": 9.0625}
PITCH_STATS = {"error": 0.1875}
FRONTIER_META = {"epoch": 3, "ACC_external": 0.5625, "Utility_Retention": 0.90625, "pool_n": 7, "kept_n": 10}
WARM_RTOL = 1e-5  # the warm-resume parity: losses and each kept tensor, of its largest element
SIGN_FLIP_SHARE = 0.01  # elements of a kept tensor past WARM_RTOL, each within two lr a step


@pytest.fixture(scope="module")
def jax_scripts():
    """The JAX package's scripts as modules (they import each other by name)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        return {name: importlib.import_module(name) for name in SCRIPT_NAMES}
    finally:
        sys.path.remove(str(ROOT / "scripts"))


class Recorder:
    """Stands in for the four recipes' ``main`` of one package: records each
    call's recipe and argv and makes its output folder; the anonymizer's its
    checkpoint folder too, and
    answers a ``valid_frontier`` evaluation with :data:`FRONTIER_META` when
    ``frontier``; ``fail_on``: a schedule substring whose anonymizer run raises."""

    def __init__(self, frontier: bool = True, fail_on: str | None = None):
        self.calls: list[tuple[str, list[str]]] = []
        self.frontier, self.fail_on = frontier, fail_on

    def fake(self, recipe: str, stats: dict):
        def main(argv):
            argv = list(argv)
            self.calls.append((recipe, argv))
            os.makedirs(argv[argv.index("--output_folder") + 1], exist_ok=True)
            brain = SimpleNamespace(test_stats=dict(stats))
            if recipe == "anonymizer":
                if self.fail_on and self.fail_on in argv[argv.index("--adversarial_schedule") + 1]:
                    raise RuntimeError("injected fault")
                os.makedirs(os.path.join(argv[argv.index("--save_folder") + 1], "ckpts"), exist_ok=True)
                if self.frontier and "valid_frontier" in argv:
                    brain.selected_ckpt_meta = dict(FRONTIER_META)
            return brain

        return main

    def install(self, monkeypatch, modules) -> None:
        for recipe, module, stats in zip(("gender_classifier", "asr_train", "anonymizer", "pitch_norm"), modules,
                                         (GENDER_STATS, ASR_STATS, ANON_STATS, PITCH_STATS)):
            monkeypatch.setattr(module, "main", self.fake(recipe, stats))


class Pair:
    """The two packages' scripts on roots of their own under ``tmp_path``,
    their recipes recorded."""

    def __init__(self, jax_scripts, tmp_path, monkeypatch, **recorder):
        self.js, self.mp = jax_scripts, monkeypatch
        self.jroot, self.proot = tmp_path / "jax", tmp_path / "port"
        self.jwork = self.jroot / "save" / "repro_gender_row"
        self.pwork = self.proot / "save" / "repro_gender_row_torch"
        self.jarch, self.parch = self.jroot / "artifacts" / "repro", self.proot / "artifacts" / "repro_torch"
        for name in SCRIPT_NAMES:
            monkeypatch.setattr(jax_scripts[name], "REPO", str(self.jroot))
        for mod in (jax_scripts["archive_repro"], jax_scripts["write_experiments"], port_archive):
            is_port = mod is port_archive
            monkeypatch.setattr(mod, "WORK", str(self.pwork if is_port else self.jwork))
            monkeypatch.setattr(mod, "ARCHIVE", str(self.parch if is_port else self.jarch))
        monkeypatch.setattr(port_archive, "REPO", str(self.proot))
        for work in (self.jwork, self.pwork):  # a planted corpus: build_corpus is skipped
            (work / "corpus").mkdir(parents=True)
            (work / "corpus" / "SPEAKERS.TXT").write_text("; speaker | sex | subset\n")
        self.jrec, self.prec = Recorder(**recorder), Recorder(**recorder)
        self.jrec.install(monkeypatch, (jax_gender, jax_asr_train, jax_anonymizer, jax_pitch))
        self.prec.install(monkeypatch, (port_gender, port_asr_train, port_anonymizer, port_pitch))

    def run_jax(self, name: str, *args: str) -> None:
        self.mp.setattr(sys, "argv", [f"{name}.py", *args])
        self.js[name].main()

    def calls(self) -> tuple[list, list]:
        def norm(calls, work):
            out = []
            for recipe, argv in calls:
                i = argv.index("--device") if "--device" in argv else None
                if i is not None:
                    assert argv[i + 1] == "cpu"
                    argv = argv[:i] + argv[i + 2:]
                out.append((recipe, [a.replace(str(work), "<WORK>") for a in argv]))
            return out

        return norm(self.jrec.calls, self.jwork), norm(self.prec.calls, self.pwork)

    def rows(self, *rel: str) -> tuple[list, list]:
        def load(path):
            if not path.exists():
                return []
            return [json.loads(line) for line in path.read_text().splitlines()]

        jrows, prows = load(self.jwork.joinpath(*rel)), load(self.pwork.joinpath(*rel))
        for r in prows:
            assert r.pop("device") == "cpu" and r.pop("card") is None, r
        for r in jrows + prows:
            r.pop("wall_s", None)
        return jrows, prows

    def assert_same(self, *jsonl: str) -> None:
        jcalls, pcalls = self.calls()
        assert pcalls == jcalls
        for rel in jsonl:
            jrows, prows = self.rows(rel)
            assert jrows and prows == jrows, rel
        for stage in ("gender", "asr"):
            jstats = json.loads((self.jwork / stage / "repro_stats.json").read_text())
            pstats = json.loads((self.pwork / stage / "repro_stats.json").read_text())
            assert {k: pstats[k] for k in jstats} == jstats
            assert pstats["device"] == "cpu" and pstats["card"] is None
        jarch = sorted(p.relative_to(self.jarch) for p in self.jarch.rglob("*") if p.is_file())
        parch = sorted(p.relative_to(self.parch) for p in self.parch.rglob("*") if p.is_file())
        assert parch == jarch


@pytest.fixture
def pair(jax_scripts, tmp_path, monkeypatch):
    return Pair(jax_scripts, tmp_path, monkeypatch)


def test_copies_are_letter_for_letter(jax_scripts):
    js = jax_scripts
    for name in ("TINY_ASR", "BASELINE_SCHEDULE"):
        assert getattr(port_repro, name) == getattr(js["repro_gender_row"], name), name
    assert port_repro._common("/r", "/o") == js["repro_gender_row"]._common("/r", "/o")
    assert port_repro.BASE == js["repro_gender_row"].BASE
    for name in ("GEN", "ADV", "E2E", "E2EC", "VARIANTS"):
        assert getattr(port_sweep, name) == getattr(js["round4_sweep"], name), name
    assert port_sweep._sched("a", "b") == js["round4_sweep"]._sched("a", "b")
    assert port_archive.FILES == js["archive_repro"].FILES


def test_repro_gender_row_main(pair):
    pair.run_jax("repro_gender_row")
    port_repro.main(["--device", "cpu"])
    pair.assert_same()
    assert [r for r, _ in pair.prec.calls] == ["gender_classifier", "asr_train", "anonymizer"]


@pytest.mark.parametrize("variant", list(port_sweep.VARIANTS))
def test_sweep_variant(pair, variant):
    pair.run_jax("round4_sweep", variant)
    assert port_sweep.main([variant, "--device", "cpu"]) == 0
    pair.assert_same("sweep_results.jsonl")
    runs = 2 if "warm_epochs" in port_sweep.VARIANTS[variant] else 1
    assert [r for r, _ in pair.prec.calls] == ["gender_classifier", "asr_train"] + ["anonymizer"] * runs
    if runs == 2:  # the warm phase and the resumed run share one output folder
        folders = {a[a.index("--output_folder") + 1] for _, a in pair.prec.calls[2:]}
        assert folders == {str(pair.pwork / f"anon_{variant}_s0")}


def test_sweep_seeds_and_the_skip_rule(pair):
    for args in (("baseline", "conf", "--seeds=0,1"), ("conf", "--seeds=1,2")):
        pair.run_jax("round4_sweep", *args)
        port_sweep.main([*args, "--device", "cpu"])
    pair.assert_same("sweep_results.jsonl")
    _, rows = pair.rows("sweep_results.jsonl")
    assert [(r["variant"], r["seed"]) for r in rows] == [("baseline", 0), ("baseline", 1), ("conf", 0),
                                                          ("conf", 1), ("conf", 2)]


def test_sweep_exits_nonzero_after_a_failing_variant(jax_scripts, tmp_path, monkeypatch):
    """Both record the variants that ran and go on past the failing one; the
    port's main then exits non-zero, the JAX script's returns normally."""
    p = Pair(jax_scripts, tmp_path, monkeypatch, fail_on='"confusion": -0.5')
    p.run_jax("round4_sweep", "baseline", "conf", "mix")
    with pytest.raises(SystemExit) as exc:
        port_sweep.main(["baseline", "conf", "mix", "--device", "cpu"])
    assert exc.value.code not in (0, None) and "conf seed=0" in str(exc.value.code)
    jrows, prows = p.rows("sweep_results.jsonl")
    assert [r["variant"] for r in prows] == ["baseline", "mix"] and prows == jrows
    assert p.calls()[1] == p.calls()[0]


def test_reeval_frontier(pair):
    for name, args in (("round4_sweep", ("conf",)), ("reeval_frontier", ("conf",))):
        pair.run_jax(name, *args)
    port_sweep.main(["conf", "--device", "cpu"])
    port_reeval.main(["conf", "--device", "cpu"])
    pair.assert_same("sweep_results.jsonl")
    _, rows = pair.rows("sweep_results.jsonl")
    assert rows[1]["variant"] == "conf_frontier" and rows[1]["selected_epoch"] == FRONTIER_META["epoch"]
    argv = pair.prec.calls[-1][1]
    assert "--eval_only" in argv and argv[argv.index("--eval_ckpt_select") + 1] == "valid_frontier"
    # a second re-evaluation is refused in both
    with pytest.raises(SystemExit):
        pair.run_jax("reeval_frontier", "conf")
    with pytest.raises(SystemExit, match="already recorded"):
        port_reeval.main(["conf", "--device", "cpu"])


def test_reeval_frontier_aborts_without_the_frontier_meta(jax_scripts, tmp_path, monkeypatch):
    p = Pair(jax_scripts, tmp_path, monkeypatch, frontier=False)
    p.run_jax("round4_sweep", "conf")
    port_sweep.main(["conf", "--device", "cpu"])
    with pytest.raises(SystemExit, match="ABORT"):
        p.run_jax("reeval_frontier", "conf")
    with pytest.raises(SystemExit, match="ABORT: the frontier branch did not run"):
        port_reeval.main(["conf", "--device", "cpu"])
    p.assert_same("sweep_results.jsonl")
    _, rows = p.rows("sweep_results.jsonl")
    assert [r["variant"] for r in rows] == ["conf"]


@pytest.mark.parametrize("frontier", [False, True])
def test_attack_retrain(pair, frontier):
    pair.run_jax("round4_sweep", "e2e_conf")
    port_sweep.main(["e2e_conf", "--device", "cpu"])
    extra = ["frontier"] if frontier else []
    pair.run_jax("attack_retrain", "e2e_conf", "0", *extra)
    port_attack.main(["e2e_conf", "0", *extra, "--device", "cpu"])
    pair.assert_same("sweep_results.jsonl", "attack_results.jsonl")
    _, rows = pair.rows("attack_results.jsonl")
    assert rows == [{"variant": "e2e_conf_frontier" if frontier else "e2e_conf", "seed": 0,
                     "model_type": "endtoend", "attack_acc": 1.0 - GENDER_STATS["error"]}]
    argv = pair.prec.calls[-1][1]
    assert argv[argv.index("--recon_model_type") + 1] == "endtoend"
    assert ("valid_frontier" in argv) == frontier


def test_attack_retrain_needs_the_swept_run(pair):
    with pytest.raises(SystemExit, match="run round4_sweep conf first"):
        port_attack.main(["conf", "--device", "cpu"])


def test_vocoder_ab(pair):
    pair.run_jax("vocoder_ab")
    port_vocoder.main(["--device", "cpu"])
    pair.run_jax("vocoder_ab")  # both methods recorded: skipped
    port_vocoder.main(["--device", "cpu"])
    pair.assert_same("vocoder_ab.jsonl")
    methods = [a[a.index("--pitch_method") + 1] for r, a in pair.prec.calls if r == "pitch_norm"]
    assert methods == ["world", "psola"]


def test_write_experiments_renders_the_jax_tables(pair):
    """The same recorded rows through both renderers: the port's document
    holds every table line of the JAX one, plus the line naming the card."""
    for name, args in (("round4_sweep", ("baseline", "conf", "--seeds=0,1")), ("reeval_frontier", ("conf",)),
                       ("attack_retrain", ("conf", "0", "frontier")), ("vocoder_ab", ())):
        pair.run_jax(name, *args)
    port_sweep.main(["baseline", "conf", "--seeds=0,1", "--device", "cpu"])
    port_reeval.main(["conf", "--device", "cpu"])
    port_attack.main(["conf", "0", "frontier", "--device", "cpu"])
    port_vocoder.main(["--device", "cpu"])
    pair.run_jax("write_experiments")
    assert port_write.main([]) == 0
    jdoc = (pair.jroot / "EXPERIMENTS.md").read_text().splitlines()
    pdoc = (pair.parch / "EXPERIMENTS.md").read_text().splitlines()
    jtable = [ln for ln in jdoc if ln.startswith("|")]
    ptable = [ln for ln in pdoc if ln.startswith("|")]
    card = [ln for ln in ptable if ln.startswith("| Ran on")]
    assert card == ["| Ran on (card, power limit; device) | — | no card (cpu) |"]
    assert [ln for ln in ptable if ln not in card] == jtable
    assert [ln for ln in pdoc if ln.startswith("STATUS")] == [ln for ln in jdoc if ln.startswith("STATUS")]
    assert not (pair.proot / "EXPERIMENTS.md").exists()


def test_archive_repro_main(pair, capsys):
    port_repro.ensure_stages(str(pair.pwork), device="cpu")
    assert port_archive.main([]) == 0
    assert "artifacts/repro_torch/gender/repro_stats.json" in capsys.readouterr().out
    assert (pair.parch / "asr" / "repro_stats.json").is_file()


@pytest.mark.parametrize("module", [port_repro, port_sweep, port_reeval, port_attack, port_vocoder])
def test_the_card_is_the_default_and_never_falls_back(module, pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(SystemExit, match="--device cpu"):
        module.main(["conf"] if module in (port_sweep, port_reeval, port_attack) else [])
    assert not pair.prec.calls


def test_parse_device():
    assert port_repro.parse_device(["conf", "--device", "cpu", "--seeds=1"]) == ("cpu", ["conf", "--seeds=1"])
    assert port_repro.parse_device(["--device=cpu"]) == ("cpu", [])
    with pytest.raises(SystemExit, match="unknown --device"):
        port_repro.parse_device(["--device", "tpu"])


# -- the warm-resume protocol against the JAX recipe -----------------------------------------


@pytest.fixture(scope="module")
def warm_runs(tmp_path_factory):
    """A recon-only fcae epoch, then the ``conf`` schedule resumed in the same
    folder to epoch 2 (``round4_sweep``'s warm protocol), in both packages,
    each first recovering one seeded checkpoint."""
    corpus = str(tmp_path_factory.mktemp("warm_ls"))
    make_fake_librispeech(corpus, utts_per_speaker=3, duration_s=0.7)
    key = jax.random.PRNGKey(0)
    variables = random_variables(JaxFCAE().init, {"params": key, "dummy": key},
                                 np.zeros((2, 36, 80), np.float32), train=False, seed=5)
    warm = port_sweep._sched(port_sweep.GEN % (1.0, 0.0, 0.0))
    outs, saved = {}, jax_anonymizer.MODEL_TYPES["fcae"]
    jax_anonymizer.MODEL_TYPES["fcae"] = shape_init(JaxFCAE)
    try:
        for name, main in (("jax", jax_anonymizer.main), ("port", port_anonymizer.main)):
            out = outs[name] = str(tmp_path_factory.mktemp(f"warm_{name}"))
            _seed_checkpoint(os.path.join(out, "save"), variables)
            for epochs, schedule in ((1, warm), (2, port_sweep.VARIANTS["conf"]["schedule"])):
                main(_argv(corpus, out, device="cpu" if name == "port" else None, model_type="fcae",
                           number_of_epochs=epochs, augmentation="null", lr_adam=0.55, n_warmup_steps=100,
                           adversarial_schedule=schedule))
    finally:
        jax_anonymizer.MODEL_TYPES["fcae"] = saved
    return outs


def test_warm_resume_matches_jax(warm_runs):
    """Neither package's anonymizer checkpoint holds Adam's moments, so each
    ``main()`` starts Adam afresh, and a first step is +-lr by the gradient's
    sign (eps 1e-9): an element whose f32 gradient is near 0 may step the
    other way. Each kept tensor: every element within WARM_RTOL of the
    tensor's largest, or within two lr a step (SIGN_FLIP_SHARE of them at
    most)."""
    got, want = _losses(warm_runs["port"]), _losses(warm_runs["jax"])
    assert len(got) == len(want) == 4  # train and valid, a line each epoch
    np.testing.assert_allclose(got, want, rtol=WARM_RTOL)
    kept = {name: _kept(out) for name, out in warm_runs.items()}
    assert [c.meta["epoch"] for c in kept["port"]] == [c.meta["epoch"] for c in kept["jax"]] == [1, 2]
    for pc, jc in zip(kept["port"], kept["jax"]):
        for part in ("counter.ckpt", "noam_scheduler.ckpt"):
            assert (json.loads((Path(pc.path) / part).read_text())
                    == json.loads((Path(jc.path) / part).read_text())), (pc.meta["epoch"], part)
        noam = json.loads((Path(pc.path) / "noam_scheduler.ckpt").read_text())
        flip = 2 * noam["n_steps"] * noam["current_lr"]  # Noam's lr grows in warm-up: the last is the largest
        pt = jax.tree_util.tree_leaves_with_path(read_tree(os.path.join(pc.path, "model.ckpt")))
        jt = dict(jax.tree_util.tree_leaves_with_path(read_tree(os.path.join(jc.path, "model.ckpt"))))
        assert len(pt) == len(jt) > 0
        for path, leaf in pt:
            want_leaf = np.asarray(jt[path])
            gap = np.abs(np.asarray(leaf) - want_leaf)
            loose = gap > WARM_RTOL * max(float(np.abs(want_leaf).max()), 1e-30)
            assert gap.max() <= flip and loose.mean() <= SIGN_FLIP_SHARE, (pc.meta["epoch"], path)


# -- one real run of the port's pipeline -----------------------------------------------------

TINY_STAGES = dict(utts=3, n_train_spk=2, n_test_spk=1, gender_batch=4, gender_epochs=1, asr_epochs=1)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    work, arch = tmp_path_factory.mktemp("pipeline_work"), tmp_path_factory.mktemp("pipeline_archive")
    kw = dict(work=str(work), archive_dir=str(arch))
    assert port_sweep.main(["conf", "--device", "cpu"], stages=TINY_STAGES, epochs=2, **kw) == 0
    assert port_reeval.main(["conf", "--device", "cpu"], **kw) == 0
    assert port_sweep.main(["e2e_warm", "--device", "cpu"], stages=TINY_STAGES, epochs=1, warm_epochs=1,
                           **kw) == 0
    assert port_attack.main(["conf", "0", "frontier", "--device", "cpu"], epochs=1, batch_size=4, **kw) == 0
    assert port_write.main([], **kw) == 0
    return work, arch


def test_pipeline_rows(pipeline):
    work, arch = pipeline
    rows = [json.loads(ln) for ln in (work / "sweep_results.jsonl").read_text().splitlines()]
    assert [(r["variant"], r["epochs"], r["warm_epochs"]) for r in rows] == [
        ("conf", 2, 0), ("conf_frontier", 2, 0), ("e2e_warm", 1, 1)]
    attack = [json.loads(ln) for ln in (work / "attack_results.jsonl").read_text().splitlines()]
    for r in rows + attack:
        assert r["device"] == "cpu" and r["card"] is None
        for k, v in r.items():
            if isinstance(v, float):
                assert math.isfinite(v), (r["variant"], k)
    assert rows[1]["selected_epoch"] in (1, 2) and rows[1]["selected_pool_n"] >= 1
    assert "selected_epoch" not in rows[0]
    assert attack[0]["variant"] == "conf_frontier" and 0.0 <= attack[0]["attack_acc"] <= 1.0
    for rel in port_archive.FILES[:3] + port_archive.FILES[4:]:
        assert (arch.joinpath(*rel)).read_bytes() == (work.joinpath(*rel)).read_bytes(), rel


def test_pipeline_warm_phase_resumed_in_place(pipeline):
    """e2e_warm's second run recovered the warm run's checkpoint: the epoch
    counter and Noam's step go on from it, and one log holds both epochs."""
    work, _ = pipeline
    out = work / "anon_e2e_warm_s0"
    ckpts = sorted(Checkpointer(str(out / "save" / "ckpts")).list_checkpoints(), key=lambda c: c.meta["epoch"])
    assert [c.meta["epoch"] for c in ckpts] == [1, 2]
    steps = [json.loads((Path(c.path) / "noam_scheduler.ckpt").read_text())["n_steps"] for c in ckpts]
    assert steps[1] == 2 * steps[0] > 0
    log = (out / "train_log.txt").read_text().splitlines()
    assert [ln.split(",")[0] for ln in log if ln.startswith("epoch")] == ["epoch: 1", "epoch: 2"]


def test_pipeline_renders_experiments(pipeline):
    _, arch = pipeline
    doc = (arch / "EXPERIMENTS.md").read_text()
    assert "| Ran on (card, power limit; device) | — | no card (cpu) |" in doc
    for variant in ("conf", "conf_frontier", "e2e_warm"):
        assert f"| {variant} | " in doc
    assert "| conf_frontier | 0 | **" in doc  # the attack table

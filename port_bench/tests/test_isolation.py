"""Nothing the harness or the reference imports is JAX or the JAX package,
compared by whole top-level names; the reference imports nothing of the
program either."""

import subprocess
import sys

from .conftest import ROOT

PROBE = """
import sys
{imports}
top = {{m.partition(".")[0] for m in sys.modules}}
print(sorted(top & {{"jax", "jaxlib", "flax", "optax", "speech_anonymization_tpu", "speech_anonymization_tpu_torch"}}))
"""


def loaded(imports: str) -> str:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    return out.stdout.strip()


def test_harness_loads_no_jax():
    imports = "\n".join(["import port_bench.run, port_bench.control, port_bench.trace",
                         "from port_bench.entries import anonymize, evaluate, train",
                         "import speech_anonymization_tpu_torch.recipes.anonymizer",
                         "import speech_anonymization_tpu_torch.recipes.asr_bundle"])
    assert loaded(imports) == "['speech_anonymization_tpu_torch']"


def test_reference_loads_nothing_of_the_program():
    imports = "from port_bench.reference import beam_search, frontend, models, numerics, scoring, training"
    assert loaded(imports) == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    import types

    from port_bench import run as bench

    for name in [m for m in sys.modules if m.partition(".")[0] in bench.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "speech_anonymization_tpu_torch_probe.sub", types.ModuleType("probe"))
    monkeypatch.setitem(sys.modules, "jaxlibrary", types.ModuleType("probe"))
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("probe"))
    assert bench.forbidden_modules() == ["flax"]

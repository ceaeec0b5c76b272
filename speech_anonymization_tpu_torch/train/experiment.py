"""Experiment directory setup: a snapshot of the config and of the environment.

Counterpart of ``speech_anonymization_tpu/train/experiment.py``
(SpeechBrain's ``create_experiment_directory``): creates the output folder,
copies the hyperparameter file there (with the overrides appended) and
writes ``env.log`` (the Python version and ``pip freeze``).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys


def create_experiment_directory(experiment_directory: str, hyperparams_to_save: str | None = None,
                                overrides: dict | str | None = None):
    os.makedirs(experiment_directory, exist_ok=True)
    if hyperparams_to_save and os.path.exists(hyperparams_to_save):
        dst = os.path.join(experiment_directory, "hyperparams.yaml")
        shutil.copyfile(hyperparams_to_save, dst)
        if overrides:
            with open(dst, "a") as f:
                f.write("\n# --- CLI overrides ---\n")
                if isinstance(overrides, dict):
                    for k, v in overrides.items():
                        f.write(f"{k}: {v}\n")
                else:
                    f.write(str(overrides) + "\n")
    try:
        freeze = subprocess.run(
            [sys.executable, "-m", "pip", "freeze", "--disable-pip-version-check"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        freeze = ""
    with open(os.path.join(experiment_directory, "env.log"), "w") as f:
        f.write(f"python {sys.version}\n")
        f.write(freeze)

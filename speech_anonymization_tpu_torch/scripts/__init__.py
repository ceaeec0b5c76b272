"""The research pipeline's entry points on the port.

Counterparts of the JAX package's ``scripts/`` of the same names: they drive
the port's recipes (``recipes/gender_classifier.py``, ``asr_train.py``,
``anonymizer.py``, ``gender_classifier_pitch_norm.py``) over the synthetic
corpus (``data/synth.py``) into the research rows, on the card unless
``--device cpu`` is given::

    python -m speech_anonymization_tpu_torch.scripts.repro_gender_row [--device cuda|cpu]
    python -m speech_anonymization_tpu_torch.scripts.round4_sweep conf e2e_warm [--seeds=0,1] [--device ...]
    python -m speech_anonymization_tpu_torch.scripts.reeval_frontier conf [seed] [--device ...]
    python -m speech_anonymization_tpu_torch.scripts.attack_retrain conf [seed] [frontier] [--device ...]
    python -m speech_anonymization_tpu_torch.scripts.vocoder_ab [--device ...]
    python -m speech_anonymization_tpu_torch.scripts.archive_repro
    python -m speech_anonymization_tpu_torch.scripts.write_experiments

The work dir is ``save/repro_gender_row_torch/``, the archive
``artifacts/repro_torch/`` (its ``EXPERIMENTS.md`` rendered by
``write_experiments``). The rows keep the JAX scripts' keys and add
``device`` and ``card`` (nvidia-smi's ``name, power.limit``; null on the
CPU).
"""

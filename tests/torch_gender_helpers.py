"""Shared pieces of the gender recipe's parity tests against the JAX package:
the recipe's objects for either package at a small x-vector width, and a JAX
``GenderBrain`` and a port ``GenderBrain`` on the same seeded weights."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speech_anonymization_tpu.models import Xvector as JaxXvector
from speech_anonymization_tpu.models import XvectorClassifier as JaxXvectorClassifier
from speech_anonymization_tpu.ops.augment import EnvCorrupt as JaxEnvCorrupt
from speech_anonymization_tpu.ops.augment import TimeDomainSpecAugment as JaxTimeDomain
from speech_anonymization_tpu.ops.fbank import Fbank as JaxFbank
from speech_anonymization_tpu.ops.normalization import InputNormalizer as JaxNormalizer
from speech_anonymization_tpu.recipes import anonymizer as jax_anonymizer
from speech_anonymization_tpu.recipes import gender_classifier as jax_recipe
from speech_anonymization_tpu.train.epoch_loop import EpochCounter as JaxEpochCounter
from speech_anonymization_tpu.train.schedulers import ReduceLROnPlateau as JaxPlateau
from speech_anonymization_tpu.train.state import TrainState as JaxTrainState
from speech_anonymization_tpu_torch.models import Xvector, XvectorClassifier
from speech_anonymization_tpu_torch.ops.augment import EnvCorrupt, TimeDomainSpecAugment
from speech_anonymization_tpu_torch.ops.fbank import Fbank
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer
from speech_anonymization_tpu_torch.recipes import anonymizer as port_anonymizer
from speech_anonymization_tpu_torch.recipes import gender_classifier as recipe
from speech_anonymization_tpu_torch.train.epoch_loop import EpochCounter
from speech_anonymization_tpu_torch.train.schedulers import ReduceLROnPlateau
from speech_anonymization_tpu_torch.utils.convert import (anonymizer_state_dict, indexed_state_dict,
                                                          load_numpy_state)
from tests.torch_port_helpers import random_variables, to_numpy

SMALL = dict(tdnn_channels=(16, 16, 16, 16, 48), lin_neurons=16)
EMB = 16
LR = 1e-3


def hparams(port: bool, env: bool = False, aug: bool = False, accum: int = 1, **extra) -> dict:
    """The recipe's objects (gender_classifier.yaml's, the x-vector at SMALL
    width) for the port (on the CPU) or the JAX package."""
    common = {"gradient_accumulation": accum, "gradient_clipping": 5.0, "lr_start": LR, "seed": 7,
              "train_logger": None, **extra}
    if port:
        return {**common, "compute_features": Fbank(device="cpu"), "mean_var_norm": InputNormalizer(dim=80),
                "embedding_model": Xvector(**SMALL, device="cpu"),
                "classifier": XvectorClassifier(lin_neurons=EMB, device="cpu"),
                "lr_annealing": ReduceLROnPlateau(LR), "epoch_counter": EpochCounter(2),
                "env_corrupt": EnvCorrupt(noise_snr_low=0.0, noise_snr_high=15.0) if env else None,
                "augmentation": TimeDomainSpecAugment(speeds=[95, 100, 105]) if aug else None}
    return {**common, "compute_features": JaxFbank(), "mean_var_norm": JaxNormalizer(dim=80),
            "embedding_model": JaxXvector(**SMALL), "classifier": JaxXvectorClassifier(lin_neurons=EMB),
            "lr_annealing": JaxPlateau(LR), "epoch_counter": JaxEpochCounter(2),
            "env_corrupt": JaxEnvCorrupt(noise_snr_low=0.0, noise_snr_high=15.0) if env else None,
            "augmentation": JaxTimeDomain(speeds=[95, 100, 105]) if aug else None}


def xvector_variables_for(batch: int, frames: int, seed: int) -> tuple[dict, dict]:
    """Seeded flax variables of the SMALL Xvector and its classifier (traced
    init, weights ~ N(0, 0.1^2), norm parameters and statistics perturbed)."""
    rng = jax.random.PRNGKey(0)
    feats = jax.ShapeDtypeStruct((batch, frames, 80), jnp.float32)
    lens = jax.ShapeDtypeStruct((batch,), jnp.float32)
    ev = random_variables(JaxXvector(**SMALL).init, rng, feats, lens, train=False, seed=seed)
    cv = random_variables(JaxXvectorClassifier(lin_neurons=EMB).init, rng,
                          jax.ShapeDtypeStruct((batch, EMB), jnp.float32), train=False, seed=seed + 1)
    return ev, cv


def recon_pair(model_type: str, seed: int):
    """A frozen anonymizer for both packages: (JAX (module, variables), the
    port's module with the same weights)."""
    module = jax_anonymizer.MODEL_TYPES[model_type]()
    rng = jax.random.PRNGKey(0)
    t0 = 36 if model_type != "fcae" else 8
    variables = random_variables(module.init, {"params": rng, "dummy": rng},
                                 jax.ShapeDtypeStruct((1, t0, 80), jnp.float32), train=False, seed=seed)
    port = port_anonymizer.MODEL_TYPES[model_type](device="cpu")
    load_numpy_state(port, anonymizer_state_dict(variables))
    return (module, jax.tree_util.tree_map(jnp.asarray, variables)), port.eval()


class GenderPair:
    """A JAX ``GenderBrain`` and the port's on the same weights: the JAX
    state is built from seeded variables (no eager flax init), the port's
    models get the same weights through ``utils/convert.py``. ``jstate``
    follows the JAX brain's train steps (its ``_train_step`` is called
    directly, with the key the test also turns into the port's draws)."""

    def __init__(self, env=False, aug=False, accum=1, recon: str | None = None, batch=4, frames=101,
                 seed=3):
        jrecon, precon = recon_pair(recon, seed + 20) if recon else (None, None)
        self.jb = jax_recipe.GenderBrain(hparams(False, env, aug, accum), recon_model=jrecon)
        self.pb = recipe.GenderBrain(hparams(True, env, aug, accum), recon_model=precon, device="cpu")
        ev, cv = xvector_variables_for(batch, frames, seed)
        params = {"embedding_model": ev["params"], "classifier": cv["params"]}
        model_state = {"embedding_model": {"batch_stats": ev["batch_stats"]},
                       "classifier": {"batch_stats": cv["batch_stats"]}}
        params = jax.tree_util.tree_map(jnp.asarray, params)
        self.jstate = JaxTrainState.create(params, jax.tree_util.tree_map(jnp.asarray, model_state),
                                           self.jb.normalizer.init_state(), self.jb.optimizer.init(params))
        load_numpy_state(self.pb.embedding_model, indexed_state_dict(ev))
        load_numpy_state(self.pb.classifier, indexed_state_dict(cv))
        self.start = to_numpy(params)

    def jax_step(self, batch, key, lr=LR, epoch=0):
        """One JAX train step from ``jstate``; -> its metrics (numpy)."""
        self.jstate, metrics = self.jb._train_step(self.jstate, tuple(jnp.asarray(x) for x in batch),
                                                   jnp.asarray(lr, jnp.float32), jnp.asarray(epoch), key)
        return {k: np.asarray(v) for k, v in metrics.items()}

    def jax_eval(self, batch, epoch=0):
        s = self.jstate
        loss, err, lp = self.jb._eval_step(s.params, s.model_state, s.norm_state,
                                           tuple(jnp.asarray(x) for x in batch), jnp.asarray(epoch))
        return float(loss), float(err), np.asarray(lp)

    def jax_tree(self, tree) -> dict:
        """A JAX ``{"embedding_model": ..., "classifier": ...}`` tree of params
        (or of Adam moments) under the port's parameter names."""
        return {f"{name}.{k}": v for name in ("embedding_model", "classifier")
                for k, v in indexed_state_dict({"params": to_numpy(tree[name])}).items()}

    def jax_stats(self) -> dict:
        ms = to_numpy(self.jstate.model_state)
        out = {}
        for name in ("embedding_model", "classifier"):
            sd = indexed_state_dict({"params": to_numpy(self.jstate.params[name]), **ms[name]})
            out.update({f"{name}.{k}": v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))})
        return out

    def port_stats(self) -> dict:
        return {f"{name}.{k}": v for name in ("embedding_model", "classifier")
                for k, v in getattr(self.pb, name).state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    def adam(self):
        """The JAX Adam state's (count, mu, nu), mu and nu under the port's names."""
        inner = self.jstate.opt_state.inner_state[0]
        return int(inner.count), self.jax_tree(inner.mu), self.jax_tree(inner.nu)


def speech_batch(batch: int, n: int, seed: int, lens=None):
    """(wavs, lens, labels) numpy: speech-like waveforms, alternating sexes."""
    from speech_anonymization_tpu_torch.tools.train_parity import speechlike

    wavs = speechlike(batch, n, seed)
    lens = np.ones(batch, np.float32) if lens is None else np.asarray(lens, np.float32)
    return wavs, lens, (np.arange(batch) % 2).astype(np.int64)


def port_batch(batch) -> tuple:
    return tuple(torch.from_numpy(np.array(x)) for x in batch)

from .schedulers import NoamScheduler, ReduceLROnPlateau
from .state import (
    SGD,
    Adam,
    TrainState,
    adam_like_reference,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgd_like_reference,
)
from .epoch_loop import EpochCounter
from .logger import FileTrainLogger
from .checkpoint import Checkpointer, PytreeRecoverable, average_checkpoints
from .experiment import create_experiment_directory
from .brain import Brain, Stage

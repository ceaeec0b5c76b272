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

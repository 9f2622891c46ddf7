"""The train path of the port (twin of `repro/train`): AdamW, the train
step, gradient compression, checkpoints and fault tolerance."""

from . import checkpoint, compression, fault, optim, step  # noqa: F401
from .optim import OptimConfig, OptState  # noqa: F401
from .step import TrainState, init_state, make_train_step  # noqa: F401

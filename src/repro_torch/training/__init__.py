from .steps import build_train_step, make_train_state, TrainState
from .loop import TrainLoop, TrainLoopConfig

from .optimizer import AdamWState, adamw_init, adamw_update  # noqa: F401
from .train_loop import TrainState, make_train_step, train_loop  # noqa: F401

from .optimizer import adamw_init, adamw_update, HParams
from .train_step import make_train_step, make_eval_step

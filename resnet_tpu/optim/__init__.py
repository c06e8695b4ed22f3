from .adam import (
    GuardedAdamState,
    adam_init,
    adam_update,
    guarded_adam,
)
from .schedules import make_schedule
from .sgd import sgd_init, sgd_update

__all__ = [
    "GuardedAdamState",
    "adam_init",
    "adam_update",
    "guarded_adam",
    "make_schedule",
    "sgd_init",
    "sgd_update",
]

from . import checkpoint, metrics, resume, systems, trainer  # noqa: F401

from .checkpoint import list_checkpoints, restore_checkpoint, save_checkpoint  # noqa: F401
from .metrics import MetricsLogger  # noqa: F401
from .resume import TrainState, latest_step, restore_train_state, save_train_state  # noqa: F401
from .systems import SU2System, SU4System, make_objective, make_per_target_objective  # noqa: F401
from .trainer import (  # noqa: F401
    CurriculumBand,
    TrainConfig,
    Trainer,
    default_curriculum,
    learning_rate_at,
)

from .checkpoint import (CheckpointManager, flatten,  # noqa: F401
                         latest_step, load_checkpoint, save_checkpoint,
                         unflatten)

from repro_torch.checkpoint.io import (
    latest_checkpoint,
    load_metadata,
    publish,
    restore,
    restore_training_state,
    save,
    save_training_state,
)

__all__ = [
    "latest_checkpoint",
    "load_metadata",
    "publish",
    "restore",
    "restore_training_state",
    "save",
    "save_training_state",
]

from repro_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager,
    frames_to_tree,
    tree_to_frames,
)
from repro_torch.train.runner import Trainer, TrainerConfig  # noqa: F401

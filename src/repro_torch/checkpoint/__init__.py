from repro_torch.checkpoint.ckpt import (CheckpointManager,  # noqa: F401
                                         latest_step, restore_checkpoint,
                                         save_checkpoint)

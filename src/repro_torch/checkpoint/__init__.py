from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa: F401
                                                 latest_step, restore, save)

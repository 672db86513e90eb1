from repro_torch.optim.adamw import (adamw_init, adamw_update,  # noqa: F401
                                     cosine_schedule, global_norm)

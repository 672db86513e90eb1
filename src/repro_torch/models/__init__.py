"""The port's model stack (dense, hybrid Mamba + MoE and xLSTM language
models so far)."""
from repro_torch.models.model import (decode_step, forward_loss,  # noqa: F401
                                      init_cache, init_params, param_count,
                                      prefill)

"""The port's model stack: the JAX package's ten architectures (dense,
MoE, MLA, VLM, encoder-decoder, hybrid Mamba + MoE and xLSTM)."""
from repro_torch.models.model import (decode_step, forward_loss,  # noqa: F401
                                      init_cache, init_params, param_count,
                                      prefill)

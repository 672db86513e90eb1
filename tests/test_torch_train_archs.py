"""The train-step parity of ``test_torch_train.py`` on the seven reduced
architectures that the port's training path took on last: qwen3-moe-
30b-a3b, kimi-k2-1t-a32b, minicpm3-4b, internvl2-2b, whisper-large-v3,
nemotron-4-15b and minitron-8b.  3 f32 steps of the port's
``make_train_step`` against ``jax.jit(repro.launch.steps.
make_train_step)`` from the JAX ``init_params`` carried across, on the
JAX package's batches (internvl2: patch embeds, whisper: frame embeds):
losses within 2e-5 relative, the global gradient norm within 1e-4, the
step-0 gradients within 5e-5 of each leaf's largest |grad|, the
parameters within ``PARAM_BOUND``.  A file of its own so that its JAX
compiles run on another test worker than the other files'."""
import pytest

from test_torch_train import (  # noqa: F401
    J, one_cpu_thread, parity_run, test_step0_gradients_match_jax,
    test_train_step_grad_norm_matches_jax, test_train_step_losses_match_jax,
    test_train_step_params_match_jax)

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "minicpm3-4b",
         "internvl2-2b", "whisper-large-v3", "nemotron-4-15b",
         "minitron-8b")


@pytest.fixture(scope="module", params=ARCHS)
def trained(request, J):
    return parity_run(J, request.param, 1, n_steps=3)

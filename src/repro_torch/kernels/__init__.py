"""The sweep's per-tick CUDA kernels, their wrappers and plain versions."""

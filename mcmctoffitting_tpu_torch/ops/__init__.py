"""Physics and statistics ops of the port (host numpy table code, batched
torch functions, and the wrappers of the hand-written CUDA kernels)."""

"""The benchmark's harness: the window, the trace, the checks and the
frozen recipes. It imports the program (``grm_tpu_torch``) only to run
it; nothing here imports JAX or the JAX package."""

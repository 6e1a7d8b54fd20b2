"""The benchmark's plain reference: the networks, the train steps and the
image ops in float32 PyTorch, the batch sampling, and the cost arithmetic.
It imports neither JAX nor the JAX package nor anything of the program
(``run.py`` checks that before every result)."""

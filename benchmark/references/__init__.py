"""Plain references: the models' forward passes in plain PyTorch over a
{name: tensor} weight dict, with no kernel, no cache and no batching trick.
They import nothing of the program and nothing of JAX; the benchmark hands
them the same weights and inputs it hands the program."""

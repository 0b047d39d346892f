"""gnnbench: the benchmark of the PyTorch and CUDA port ``gespmm_tpu_torch``.

One run trains one cell (a model configuration under a traffic mix) for a
fixed window and prints one JSON line; ``python -m gnnbench.run --help``.
Everything that belongs to one configuration, traffic mix, model kind or
metric is a file of its own, found by name (README.md).
"""

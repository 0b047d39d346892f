"""Plain PyTorch references of the model kinds, one file a kind
(``reference/<kind>.py``: ``param_shapes(config)`` and ``forward``).  They
import neither JAX, nor the JAX package, nor the program."""

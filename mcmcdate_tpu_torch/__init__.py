"""mcmcdate_tpu_torch — the PyTorch / CUDA port of mcmcdate_tpu.

State lives in torch tensors with a leading chain axis on an explicit
device; the device hot path runs through hand-written CUDA kernels for
Hopper (``kernels/``), each with a plain PyTorch version beside it that
CPU tensors take.  The package imports no JAX: host code it shares with
the JAX package comes only from that package's NumPy-only modules
(``tree/``, ``utils/simulate``, ``utils/native``, ``engine/diagnostics``).
"""

__version__ = "0.1.0"

"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

One wrapper module per kernel: ``prior_terms`` (K1) and ``whiten`` (K2);
``ticket_step`` (T1 ``ticket_prologue`` and T3 ``ticket_scan``) and
``accept_select`` (K3, the ticket epilogue) for the sequential sweep; K4
(the likelihood point
step: ``point_step``'s ``point_lik_prologue`` and ``point_lik_epilogue``
around ``point_scan``, the accept scan), K5 (the
likelihood range-block step: ``range_step``'s ``range_lik_prologue`` and
``range_lik_epilogue`` around ``range_scan``, the Gram blocks and accept
scan), ``contra_step`` (K6, with two wrappers: ``contra_slide`` and
``contra_range``) and ``glob_step`` (the global-move families: G1
``glob_scan``, G2 ``glob_dense_prologue`` and G3 ``glob_dense_epilogue``)
for the ticket-batched one.
A wrapper runs the plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors (or raises); it counts its launches in
``<wrapper>.launches``.  ``build`` compiles ``csrc/*.cu`` with ``nvcc`` at
first use.
"""

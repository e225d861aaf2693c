"""Host utilities: the native Newick parser and the fixture simulator
(copies of the JAX package's NumPy-only modules), and the entry points'
device rule (``device.py``)."""

"""Sampler engine: proposals, the sequential MHG sweep, chains, I/O."""

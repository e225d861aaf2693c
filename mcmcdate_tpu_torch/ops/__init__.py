"""Log densities and proposal samplers on torch tensors."""

"""Host-side file formats: likelihood data and node-prior specs."""

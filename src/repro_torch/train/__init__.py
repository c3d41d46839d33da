"""Training step and loop of the port."""

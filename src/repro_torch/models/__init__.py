"""Model definitions of the port."""

"""Serving front-ends of the port."""

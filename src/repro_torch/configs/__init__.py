"""Model configurations of the port: copies of the JAX package's LM config
modules, resolved by the same ``--arch`` names."""

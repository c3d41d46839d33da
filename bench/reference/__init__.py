"""Plain PyTorch references: no kernel, cache or batching of the program,
float32 with TF32 off."""

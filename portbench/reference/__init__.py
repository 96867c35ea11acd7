"""Plain PyTorch references of the benchmark's configurations: float32,
TF32 off, no kernel and nothing of the program under test."""

"""Host utilities of the port: logging, preemption signals, TensorBoard
scalars, `.pth` checkpoints."""

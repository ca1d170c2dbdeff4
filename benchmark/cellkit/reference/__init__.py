"""A frozen plain-PyTorch reference of the training step the cells time."""

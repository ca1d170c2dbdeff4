"""Training: the optimizer, densification, the trainer and its reporting."""

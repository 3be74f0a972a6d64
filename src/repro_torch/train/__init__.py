"""Training substrate: the optimizer and its schedule."""

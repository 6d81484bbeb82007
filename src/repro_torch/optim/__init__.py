"""Client optimizers."""

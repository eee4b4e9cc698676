"""Running statistics of the reward normaliser."""

"""Policy network and its input processors."""

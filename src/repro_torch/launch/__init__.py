"""launch."""

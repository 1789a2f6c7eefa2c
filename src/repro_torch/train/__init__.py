"""Step functions (the serving steps only, so far)."""

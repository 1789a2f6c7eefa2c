"""Synthetic data for the port's launchers (numpy only)."""

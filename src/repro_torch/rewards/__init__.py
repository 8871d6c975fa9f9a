"""Verifiable rewards of the port (copies of repro/rewards)."""

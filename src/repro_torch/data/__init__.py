"""Prompt data of the port (copies of repro/data)."""

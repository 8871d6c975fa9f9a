"""Generation engine of the port: sampling and the decode loop."""

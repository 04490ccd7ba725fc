"""The port's networks."""

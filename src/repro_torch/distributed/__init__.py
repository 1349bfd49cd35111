"""Step builders of the port (single device so far)."""

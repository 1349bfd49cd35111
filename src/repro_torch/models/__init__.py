"""Model code of the port (decoder family so far)."""

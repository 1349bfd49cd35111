"""See bench/__init__.py."""

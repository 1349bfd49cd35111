"""Step builders of the port (one device or a mesh), the mesh rules and
the sums that span ranks."""

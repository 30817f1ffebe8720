"""Read simulator (noise projection)."""

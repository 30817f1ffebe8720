"""Reference database (RefDB)."""

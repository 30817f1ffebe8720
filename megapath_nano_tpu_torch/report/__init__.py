"""Writers for alignment outputs."""

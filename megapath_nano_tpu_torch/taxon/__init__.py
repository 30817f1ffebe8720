"""Taxon profile: placement, the noise stack, best alignment, abundance."""

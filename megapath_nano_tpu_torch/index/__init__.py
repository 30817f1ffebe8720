"""Minimizer index (host build, sorted-array layout)."""

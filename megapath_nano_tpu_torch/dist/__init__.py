"""Sharded mapping over a partitioned index."""

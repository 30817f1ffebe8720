"""Host helpers of the port (numpy only)."""

"""Framework-neutral core: metrics (numpy)."""

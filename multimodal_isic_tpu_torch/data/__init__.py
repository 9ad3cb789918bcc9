"""Data: eval preprocessing (torch), crops and synthetic samples (numpy)."""

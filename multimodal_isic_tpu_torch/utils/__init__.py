"""Utilities: timing on the card."""

"""Utilities: timing on the card, local run logging."""

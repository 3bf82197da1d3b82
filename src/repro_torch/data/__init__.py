"""Synthetic token data (the serving traffic's prompt text)."""

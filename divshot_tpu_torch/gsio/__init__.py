"""Splat model I/O and synthetic scenes."""

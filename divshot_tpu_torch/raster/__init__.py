"""Projection, binning, compositing and the viewer render path."""

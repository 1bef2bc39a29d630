"""Splat model: geometry math, camera, parameters, SH colour."""

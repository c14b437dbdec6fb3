"""Geometry, warping, the cost volume and the depth tail."""

"""Primitives, the Haar transform, the plain scan and kernel K1."""

"""Attention ops: the plain reference and the flash kernel K1."""

"""Kernel evaluation and linear algebra of the port."""

"""Dense linear algebra of the gram-free path."""

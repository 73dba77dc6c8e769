"""GP models of the port."""

"""LipNet training of the port."""

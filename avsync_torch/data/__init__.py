"""Host-side data loading for the port."""

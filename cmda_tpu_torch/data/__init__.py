"""Host-side data helpers (numpy/PIL) of the port."""

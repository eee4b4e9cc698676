"""Host-side scene compiler (numpy) and its tensor tables."""
